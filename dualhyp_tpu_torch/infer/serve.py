"""Continuous-batching correction serving loop.

Counterpart of `dualhyp_tpu/infer/serve.py`. The batched evaluator
(`cli.inference_ger.run_inference`) decodes in lockstep: a batch takes as
long as its slowest row, and finished rows idle. `ContinuousBatcher` keeps
a fixed pool of decode SLOTS instead: when a request finishes, its slot is
refilled with the next queued prompt while the others keep decoding. Each
host round (`poll`) runs `chunk_steps` speculative draft-and-verify steps
(`infer/decode.lookup_step` or `anchored_step`) with no host sync, then
reads ONE packed (4, slots) status tensor (lengths, emitted, done,
budget) and gathers token rows only for the slots that finished.

Per-request output budgets are supported (the lockstep evaluator runs a
whole batch to one cap). Greedy, and token-identical to `generate(...,
top_k=1)` per request (the eval protocol, ref: inference/ger.py:74-81).
A refill prefills its prompts as a batch of a bucket size (1, 2, 4, 8, 16,
32, padded with dummy rows) at a padded length (64, 128, ... up to
block_size - 1), as the JAX package does, into a fresh (rows, block_size +
draft_len + 1) cache that is copied into the slots whole.

On a mesh (the model built with `GPT(mesh=)`) the slot pool shards over
`data x fsdp`, rounded up so that the extent divides it (the JAX package's
rule); each rank holds its slots' device state and runs the model's
collectives (tensor, expert) with its group. The host bookkeeping (which
request sits in which slot, the queue) is the same on every rank, kept so
by one rule: global rank 0 owns the queue (`submit` counts there) and, at
the start of each `poll`, broadcasts the requests submitted since the last
one (`broadcast_object_list` at chunk boundaries, never within a chunk).
Every rank then refills alike: a refill's prefill runs every admitted
prompt on every rank (the rows are independent) and each rank keeps its
slots' rows. After a chunk the packed status and, when a slot finished,
the token rows are all-gathered over `data x fsdp`, so every rank returns
the same records. Ranks other than 0 follow rank 0 with `follow()` until it
calls `close()`.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from dualhyp_tpu_torch.infer.decode import anchored_step, find_subsequence_span, lookup_step
from dualhyp_tpu_torch.models.gpt import GPT
from dualhyp_tpu_torch.parallel import comm

# refill-batch buckets (the JAX package compiles one prefill a bucket; the
# port keeps its shapes, so the same kernel paths run)
_REFILL_BUCKETS = (1, 2, 4, 8, 16, 32)


class ContinuousBatcher:
    """Fixed-slot continuous batching over the speculative decode state.

    model: a `GPT` (its device runs everything; LoRA merged and quantized
    or not). slots: the decode pool's width; max_new_tokens: the default
    per-request budget (150, the eval protocol); chunk_steps: verify steps
    a host round. draft_source: "lookup" (suffix n-grams over the whole
    buffer) or "anchored" (each request's best-hypothesis span with a
    monotone pointer, per slot falling back to the suffix lookup when no
    span was submitted); both token-identical to greedy. kv_quant "int8":
    an int8 slot-pool KV cache with per-slot scales (outputs may shift
    within the quantization's rounding). mesh: the model's mesh (None:
    `model.mesh`); see the module docstring.

    `chunks` counts the chunks run, `host_reads` the reads of device data
    on the host (a status read a chunk, and a row gather a chunk in which a
    slot finished) and `row_gathers` the second kind."""

    def __init__(self, model: GPT, *, slots: int = 16, max_new_tokens: int = 150,
                 draft_len: int = 8, ngram: int = 3, chunk_steps: int = 16,
                 eos_id: Optional[int] = None, mesh=None, draft_source: str = "lookup",
                 kv_quant: Optional[str] = None):
        if mesh is not None and mesh is not model.mesh:
            raise ValueError("the model was built on another mesh than the batcher's")
        if draft_source not in ("lookup", "anchored"):
            raise ValueError(f"draft_source {draft_source!r} not in ('lookup', 'anchored')")
        if draft_len < 1:
            raise ValueError("draft_len must be >= 1")
        self.model = model
        self.cfg = model.cfg
        self.anchored = draft_source == "anchored"
        self.slots = slots
        self.max_new = max_new_tokens
        self.draft_len = draft_len
        self.ngram = ngram
        self.chunk_steps = chunk_steps
        self.eos_id = eos_id
        self.kv_quant = kv_quant
        self.prompt_budget = self.cfg.block_size - 1
        self.buf = self.cfg.block_size + draft_len + 1
        self.chunks = self.host_reads = self.row_gathers = 0
        self.mesh = model.mesh
        self.local_slots, self._lo, self._pool_group = slots, 0, None
        self._inbox: List[tuple] = []
        self._closing = self.stopped = False
        if self.mesh is not None:
            extent = self.mesh.extent("data", "fsdp")
            # round the pool up so that the data x fsdp extent divides it
            self.slots = -(-slots // extent) * extent
            self.local_slots = self.slots // extent
            self._lo = self.mesh.index("data", "fsdp") * self.local_slots
            self._pool_group = self.mesh.group("data", "fsdp")
            self._lead = not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0

    # ---- device pieces ----
    @torch.no_grad()
    def _chunk(self):
        """`chunk_steps` verify steps over the pool; returns the packed
        (4, slots) status on the device. No host sync."""
        state, budget = self._state, self._budget
        for _ in range(self.chunk_steps):
            if self.anchored:
                core, span_start, span_len = state[:8], state[8], state[9]
                state = anchored_step(self.model, core, span_start, span_len,
                                      draft_len=self.draft_len, ngram=self.ngram,
                                      eos_id=self.eos_id, max_new_tokens=budget)
                state = state + (span_start, span_len)
            else:
                state = lookup_step(self.model, state, draft_len=self.draft_len,
                                    ngram=self.ngram, eos_id=self.eos_id,
                                    max_new_tokens=budget)
        self._state = state
        tokens, lengths, emitted, cache, done = state[:5]
        status = torch.stack([lengths, emitted, done.long(), budget])
        if self._pool_group is not None:
            status = comm._all_gather(status, 1, self._pool_group)
        return status

    @torch.no_grad()
    def _refill_rows(self, r: int, t: int, slot_ids, pids, plens, caps, span_start,
                     span_len) -> None:
        """Prefill r prompts (the first n = len(slot_ids) real, the rest
        padding) into a fresh cache and copy the real rows into their
        slots: tokens, lengths, emitted, done, last, budget, the cache (all
        buf slots) and, anchored, the pointer and span. On a mesh, the rows
        whose slots this rank holds."""
        model, device = self.model, self.model.device
        pids = torch.from_numpy(pids).to(device)
        plens = torch.from_numpy(plens).to(device)
        small = model.init_cache(r, self.buf, quantize=self.kv_quant)
        first = model.prefill(pids, plens, small).argmax(dim=-1)
        fdone = (torch.zeros(r, dtype=torch.bool, device=device) if self.eos_id is None
                 else first == self.eos_id)
        rows = torch.zeros((r, self.buf), dtype=torch.long, device=device)
        rows[:, :t] = pids
        rows[torch.arange(r, device=device), plens] = torch.where(fdone, 0, first)
        step = (~fdone).long()
        n = len(slot_ids)
        if self.mesh is not None:
            # the admitted rows this rank's slots take, and those slots
            mine = [(row, slot - self._lo) for row, slot in enumerate(slot_ids)
                    if self._lo <= slot < self._lo + self.local_slots]
            if not mine:
                return
            sel = torch.tensor([row for row, _ in mine], device=device)
            rows, plens, first, fdone, step = (t[sel] for t in (rows, plens, first, fdone, step))
            small = [[c[sel] for c in layer] for layer in small]
            caps, span_start, span_len = (a[[row for row, _ in mine]]
                                          for a in (caps, span_start, span_len))
            slot_ids, n = [slot for _, slot in mine], len(mine)
        idx = torch.from_numpy(np.asarray(slot_ids, np.int64)).to(device)
        tokens, lengths, emitted, cache, done, last, steps = self._state[:7]
        tokens[idx] = rows[:n]
        lengths[idx] = (plens + step)[:n]
        emitted[idx] = step[:n]
        done[idx] = fdone[:n]
        last[idx] = first[:n]
        self._budget[idx] = torch.from_numpy(caps[:n]).to(device)
        for layer, small_layer in zip(cache, small):
            for c, s in zip(layer, small_layer):
                c[idx] = s[:n]
        if self.anchored:
            ptr, ss, sl = self._state[7:10]
            ptr[idx] = 0
            ss[idx] = torch.from_numpy(span_start[:n]).to(device)
            sl[idx] = torch.from_numpy(span_len[:n]).to(device)

    def _empty_state(self):
        s, buf, device = self.local_slots, self.buf, self.model.device

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=device)

        state = (zeros(s, buf), torch.ones(s, dtype=torch.long, device=device), zeros(s),
                 self.model.init_cache(s, buf, quantize=self.kv_quant),
                 torch.ones(s, dtype=torch.bool, device=device),  # inactive
                 zeros(s), 0)
        if self.anchored:
            state = state + (zeros(s), zeros(s), zeros(s))  # pointer, span start, span len
        return state, zeros(s)

    def _sync(self) -> bool:
        """On a mesh: rank 0's requests submitted since the last call join
        every rank's queue (one broadcast). Returns whether rank 0 has
        closed the pool."""
        if self.mesh is None:
            return False
        payload = comm.broadcast_objects([self._inbox, self._closing])
        self._queue.extend(payload[0])
        self._inbox = []
        return payload[1]

    def close(self) -> None:
        """Rank 0 (on a mesh): release the ranks that `follow`."""
        if self.mesh is not None and self._lead:
            self._closing = True
            self._sync()
        self.stopped = True

    def follow(self) -> None:
        """A rank other than 0 (on a mesh): run the polls rank 0 runs, in
        step with it, until it calls `close`."""
        while not self.stopped:
            self.poll()

    # ---- incremental (live-serving) API ----
    def start(self) -> None:
        """Initialise the slot pool for incremental submit()/poll()."""
        self._state, self._budget = self._empty_state()
        # (id, prompt_len, t_submit, t_enter): latency_s covers the queue too
        self._slot_req = [None] * self.slots
        self._queue: List[tuple] = []
        self._buckets = sorted({b for b in _REFILL_BUCKETS if b < self.slots} | {self.slots})
        self._refill()

    def submit(self, rid, prompt, max_new: Optional[int] = None,
               hypothesis: Optional[Sequence[int]] = None) -> None:
        """Enqueue one request; it enters a slot at the next poll().

        hypothesis (anchored only): the request's best-hypothesis token ids;
        their span in the prompt anchors the draft pointer (absent or not
        found: the slot falls back to the suffix lookup). Raises on a prompt
        that cannot fit the model's context or a budget below 1."""
        prompt = list(prompt)
        cap = self.max_new if max_new is None else int(max_new)
        if cap <= 0:
            raise ValueError(f"max_new must be positive, got {cap}")
        if len(prompt) + 1 > self.cfg.block_size:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds block_size "
                             f"{self.cfg.block_size}; truncate before submitting")
        span = (0, 0)
        if self.anchored and hypothesis is not None:
            span = find_subsequence_span(prompt, list(hypothesis))
        item = (rid, prompt, cap, time.perf_counter(), span)
        if self.mesh is None:
            self._queue.append(item)
        elif self._lead:
            self._inbox.append(item)  # broadcast at the next poll

    @property
    def pending(self) -> int:
        return (len(self._queue) + len(self._inbox)
                + sum(1 for s in self._slot_req if s is not None))

    def _refill(self) -> None:
        free = [i for i in range(self.slots) if self._slot_req[i] is None]
        if not free or not self._queue:
            return
        todo = []
        now = time.perf_counter()
        while free and self._queue and len(todo) < self._buckets[-1]:
            rid, prompt, cap, t_sub, span = self._queue.pop(0)
            cap = max(min(cap, self.cfg.block_size - len(prompt)), 1)
            slot = free.pop()
            self._slot_req[slot] = (rid, len(prompt), t_sub, now)
            todo.append((slot, prompt, cap, span))
        r = next(b for b in self._buckets if b >= len(todo))
        t_max = max(len(p) for _, p, _, _ in todo)
        t_pad = 64  # a small set of padded lengths, as the JAX package's
        while t_pad < t_max:
            t_pad *= 2
        t_pad = min(t_pad, self.prompt_budget)
        pids = np.zeros((r, t_pad), np.int64)
        plens = np.ones((r,), np.int64)
        caps = np.ones((r,), np.int64)
        span_start = np.zeros((r,), np.int64)
        span_len = np.zeros((r,), np.int64)
        for row, (slot, prompt, cap, span) in enumerate(todo):
            pids[row, :len(prompt)] = prompt
            plens[row] = len(prompt)
            caps[row] = cap
            span_start[row], span_len[row] = span
        self._refill_rows(r, t_pad, [slot for slot, _, _, _ in todo], pids, plens, caps,
                          span_start, span_len)

    def poll(self) -> List[dict]:
        """Admit queued requests, run one chunk, and return the newly
        completed records ({id, tokens, prompt_len, latency_s, queue_s,
        decode_s}; tokens hold the prompt, EOS excluded). [] when idle."""
        if self._sync():
            self.stopped = True
            return []
        self._refill()
        if all(s is None for s in self._slot_req):
            return []
        status = self._chunk()
        self.chunks += 1
        h_lengths, h_emitted, h_done, h_budget = status.cpu().numpy()
        self.host_reads += 1
        now = time.perf_counter()
        finished = [i for i in range(self.slots) if self._slot_req[i] is not None
                    and (h_done[i] or h_emitted[i] >= h_budget[i])]
        results: List[dict] = []
        if finished:
            idx = torch.tensor(finished, device=self.model.device)
            tokens = self._state[0]
            if self._pool_group is not None:
                tokens = comm._all_gather(tokens, 0, self._pool_group)
            rows = tokens[idx].cpu().numpy()
            self.host_reads += 1
            self.row_gathers += 1
            for row, slot in enumerate(finished):
                rid, plen, t_sub, t_enter = self._slot_req[slot]
                n = int(h_lengths[slot])
                results.append({"id": rid, "tokens": rows[row, :n].tolist(),
                                "prompt_len": plen,
                                "latency_s": now - t_sub,  # submit() -> completion
                                "queue_s": t_enter - t_sub, "decode_s": now - t_enter})
                self._slot_req[slot] = None
        self._refill()
        return results

    def serve(self, requests: Iterable[Sequence]) -> List[dict]:
        """requests: (id, prompt ids), (id, prompt, max_new) or (id, prompt,
        max_new, hypothesis ids). Returns one record a request in
        completion order (see `poll`)."""
        self.start()
        for req in requests:
            self.submit(req[0], req[1], req[2] if len(req) > 2 else None,
                        req[3] if len(req) > 3 else None)
        results: List[dict] = []
        if self.mesh is not None:
            # the first poll brings rank 0's requests to every rank
            results.extend(self.poll())
        while self.pending:
            results.extend(self.poll())
        return results
