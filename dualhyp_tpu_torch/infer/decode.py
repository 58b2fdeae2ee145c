"""Batched autoregressive decoding with a fixed-size KV cache.

Counterpart of `dualhyp_tpu/infer/decode.py`. `sample_token` and `generate`
(lockstep, greedy or top-k):

  * the whole batch decodes in lockstep from right-padded, ragged prompts;
  * the first token comes from the prefill logits at each row's last valid
    position;
  * sampling matches the reference: logits / temperature, top-k mask,
    categorical draw; top_k=1 is argmax, the eval protocol;
  * an EOS token is neither written nor counted; a finished row keeps its
    length and its cache slots;
  * the loop ends early once every row has finished.

Where the JAX package runs a `lax.while_loop`, this is a Python loop that
asks the device once a step whether every row is done.

Speculative decoding, greedy and token-identical to `generate(...,
top_k=1)`: each step drafts `draft_len` tokens a row, verifies them and a
bonus token in one `GPT.verify_step`, and emits the accepted prefix and
the model's next token.
  * `generate_lookup` / `lookup_step`: the draft continues the latest
    occurrence of the text's longest suffix n-gram (n = ngram..1);
  * `generate_anchored` / `anchored_step`: the draft follows the best
    hypothesis's span in the prompt with a monotone pointer, falling back
    to the suffix lookup (`find_subsequence_span` finds the span).
A step makes no host sync: the n-gram search is `unfold` plus `all` plus a
masked max, the accepted prefix a `cumprod`, the write-back a gather and a
scatter. The generate loops read one flag a verify step; the serving loop
(`infer/serve.py`) runs steps in chunks and reads once a chunk.
"""

from __future__ import annotations

from typing import Optional

import torch

from dualhyp_tpu_torch.models.gpt import GPT


def sample_token(logits, *, temperature: float, top_k: Optional[int],
                 generator: Optional[torch.Generator] = None):
    """(B, V) logits -> (B,) token ids (ref: generate/base.py:62-70)."""
    if top_k is not None and top_k == 1:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(temperature, 1e-6)
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: GPT, prompt_ids, prompt_lengths, *, max_new_tokens: int = 150,
             temperature: float = 1.0, top_k: Optional[int] = None,
             eos_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             kv_quant: Optional[str] = None):
    """prompt_ids: (B, T) right-padded; prompt_lengths: (B,). kv_quant:
    "int8" decodes against an int8 KV cache (`GPT.init_cache`).

    Returns (tokens (B, T + max_new_tokens), total_lengths (B,)), int64 on
    the model's device; total_lengths counts the prompt and the generated
    tokens without the EOS token."""
    device = model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).long()
    prompt_lengths = torch.as_tensor(prompt_lengths, device=device).long()
    b, t = prompt_ids.shape
    max_seq = t + max_new_tokens
    if max_seq > model.cfg.block_size:
        raise ValueError(f"{max_seq} exceeds block_size {model.cfg.block_size}")
    rows = torch.arange(b, device=device)

    cache = model.init_cache(b, max_seq, quantize=kv_quant)
    logits = model.prefill(prompt_ids, prompt_lengths, cache)
    tokens = torch.zeros((b, max_seq), dtype=torch.long, device=device)
    tokens[:, :t] = prompt_ids

    first = sample_token(logits, temperature=temperature, top_k=top_k,
                         generator=generator)
    done = (torch.zeros(b, dtype=torch.bool, device=device) if eos_id is None
            else first == eos_id)
    tokens[rows, prompt_lengths] = torch.where(done, 0, first)
    lengths = prompt_lengths + (~done).long()
    last = first

    step = 0
    while step < max_new_tokens - 1 and not bool(done.all()):
        # `last` sits at slot lengths-1; the model predicts slot `lengths`
        logits = model.decode_step(last, lengths - 1, cache, active=~done)
        tok = sample_token(logits, temperature=temperature, top_k=top_k,
                           generator=generator)
        newly_done = done if eos_id is None else (done | (tok == eos_id))
        tokens[rows, lengths] = torch.where(newly_done, 0, tok)
        lengths = torch.where(newly_done, lengths, lengths + 1)
        done, last = newly_done, tok
        step += 1
    return tokens, lengths


def _window(tokens, start, size: int):
    """tokens[b, start[b]:start[b] + size] for each row, with the start
    clamped so the window fits, as `lax.dynamic_slice` clamps it. Returns
    (the window (B, size), its column indices (B, size))."""
    start = start.clamp(min=0, max=tokens.shape[1] - size)
    cols = start[:, None] + torch.arange(size, device=tokens.device)[None, :]
    return torch.gather(tokens, 1, cols), cols


def _suffix_matches(tokens, lengths, n: int):
    """Window starts j (B, S - n + 1) where tokens[j:j+n] equals the row's
    last n tokens (tokens[lengths - n:lengths], start clamped at 0)."""
    ctx, _ = _window(tokens, lengths - n, n)
    windows = tokens.unfold(1, n, 1)  # (B, S - n + 1, n), a view
    return (windows == ctx[:, None, :]).all(-1)


def _lookup_propose(tokens, lengths, *, draft_len: int, ngram: int):
    """Longest-suffix lookup with n-gram fallback (`_lookup_propose` of the
    JAX package, for all rows at once): the draft (B, D) continues the most
    recent occurrence of the longest suffix n-gram (n = ngram..1) that ends
    strictly inside the text so far; zeros where none matches."""
    b, s = tokens.shape
    draft = torch.zeros((b, draft_len), dtype=tokens.dtype, device=tokens.device)
    have = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    for n in range(ngram, 0, -1):
        jpos = torch.arange(s - n + 1, device=tokens.device)[None, :]
        ok = _suffix_matches(tokens, lengths, n) & (jpos + n <= lengths[:, None] - 1)
        j = torch.where(ok, jpos, -1).max(dim=1).values  # the latest match
        d, _ = _window(tokens, j.clamp(min=0) + n, draft_len)
        take = ~have & (j >= 0)
        draft = torch.where(take[:, None], d, draft)
        have = have | (j >= 0)
    return draft


def _anchored_propose(tokens, lengths, ptr, span_start, span_len, *, draft_len: int,
                      ngram: int):
    """Hypothesis-anchored draft with a monotone pointer (`_anchored_propose`
    of the JAX package, for all rows at once): the suffix n-gram is searched
    only inside the row's hypothesis span, at continuation positions >= ptr,
    taking the EARLIEST match; rows with no match fall back to
    `_lookup_propose`. Returns (draft (B, D), span_pos (B,): the
    continuation's span-relative index, -1 where the fallback drafted)."""
    b, s = tokens.shape
    draft = torch.zeros((b, draft_len), dtype=tokens.dtype, device=tokens.device)
    have = torch.zeros(b, dtype=torch.bool, device=tokens.device)
    span_pos = torch.full((b,), -1, dtype=lengths.dtype, device=tokens.device)
    usable = (span_len > 0)[:, None]
    for n in range(ngram, 0, -1):
        jpos = torch.arange(s - n + 1, device=tokens.device)[None, :]
        rel = jpos - span_start[:, None]  # span-relative window start
        ok = (_suffix_matches(tokens, lengths, n) & (rel >= 0)
              & (rel + n <= span_len[:, None]) & (rel + n >= ptr[:, None]) & usable)
        j = torch.where(ok, jpos, s).min(dim=1).values  # the earliest match
        found = j < s
        d, _ = _window(tokens, j.clamp(max=s - 1) + n, draft_len)
        take = ~have & found
        draft = torch.where(take[:, None], d, draft)
        span_pos = torch.where(take, j - span_start + n, span_pos)
        have = have | found
    fallback = _lookup_propose(tokens, lengths, draft_len=draft_len, ngram=ngram)
    return torch.where(have[:, None], draft, fallback), span_pos


def _verify_and_accept(model: GPT, state, draft, *, eos_id, max_new_tokens):
    """Verify `draft` (B, D) after each row's last token in one
    `GPT.verify_step`, emit the accepted prefix and the bonus token (EOS
    neither written nor counted) for the active rows, and advance the
    state. Returns (the new state, n_acc (B,), active (B,))."""
    tokens, lengths, emitted, cache, done, last, steps = state
    b = tokens.shape[0]
    draft_len = draft.shape[1]
    k_win = draft_len + 1
    active = ~done & (emitted < max_new_tokens)
    chunk = torch.cat([last[:, None], draft], dim=1)  # (B, K)
    out = model.verify_step(chunk, lengths - 1, cache).argmax(dim=-1)  # (B, K)

    # accepted prefix: draft i counts iff it and every earlier one equal the
    # model's argmax continuation
    n_acc = (draft == out[:, :draft_len]).long().cumprod(dim=1).sum(dim=1)
    iidx = torch.arange(k_win, device=tokens.device)[None, :]
    if eos_id is None:
        first_eos = torch.full((b,), k_win, dtype=n_acc.dtype, device=tokens.device)
    else:
        eos_hit = (iidx <= n_acc[:, None]) & (out == eos_id)
        first_eos = torch.where(eos_hit, iidx, k_win).min(dim=1).values
    emit = torch.minimum(first_eos, n_acc + 1)
    emit = torch.minimum(emit, max_new_tokens - emitted)
    emit = torch.where(active, emit, 0)
    newly_done = done | (active & (first_eos <= n_acc))

    # the emitted prefix of `out` over each row's window at `lengths`
    cur, cols = _window(tokens, lengths, k_win)
    tokens.scatter_(1, cols, torch.where(iidx < emit[:, None], out.to(tokens.dtype), cur))
    # the last emitted token continues the row; its K/V is cached already
    # (an accepted draft) or is rewritten, the same, by the next chunk
    next_last = torch.gather(out, 1, (emit - 1).clamp(min=0)[:, None])[:, 0]
    last = torch.where(emit > 0, next_last.to(last.dtype), last)
    state = (tokens, lengths + emit, emitted + emit, cache, newly_done, last, steps + 1)
    return state, n_acc, active


def lookup_step(model: GPT, state, *, draft_len: int, ngram: int, eos_id: Optional[int],
                max_new_tokens):
    """One speculative draft-and-verify step over the decode state
    (tokens, lengths, emitted, cache, done, last, steps) (`lookup_step` of
    the JAX package). Inactive rows (done, or at their budget) emit
    nothing. max_new_tokens: an int, or a (B,) tensor of per-row budgets
    (serving). The cache is written in place; no host sync."""
    draft = _lookup_propose(state[0], state[1], draft_len=draft_len, ngram=ngram)
    return _verify_and_accept(model, state, draft, eos_id=eos_id,
                              max_new_tokens=max_new_tokens)[0]


def anchored_step(model: GPT, state, span_start, span_len, *, draft_len: int, ngram: int,
                  eos_id: Optional[int], max_new_tokens):
    """One hypothesis-anchored draft-and-verify step (`anchored_step` of the
    JAX package): state is `lookup_step`'s with the per-row span pointer
    appended. The pointer advances by the accepted span tokens; on the
    fallback or a full rejection it stays."""
    ptr = state[7]
    draft, span_pos = _anchored_propose(state[0], state[1], ptr, span_start, span_len,
                                        draft_len=draft_len, ngram=ngram)
    new, n_acc, active = _verify_and_accept(model, state[:7], draft, eos_id=eos_id,
                                            max_new_tokens=max_new_tokens)
    ptr = torch.where(active & (span_pos >= 0), span_pos + n_acc, ptr)
    return new + (ptr,)


def _start_speculative(model: GPT, prompt_ids, prompt_lengths, *, max_new_tokens: int,
                       draft_len: int, eos_id, kv_quant):
    """Prefill, the first greedy token written at each prompt's end (not an
    EOS), and the state tuple of a speculative generate; the buffer holds
    t + max_new_tokens + draft_len + 1 slots, so a chunk's writes never
    clamp. Returns (state, t)."""
    if draft_len < 1:
        raise ValueError("draft_len must be >= 1 (use generate() otherwise)")
    device = model.device
    prompt_ids = torch.as_tensor(prompt_ids, device=device).long()
    prompt_lengths = torch.as_tensor(prompt_lengths, device=device).long()
    b, t = prompt_ids.shape
    if t + max_new_tokens > model.cfg.block_size:
        raise ValueError(f"{t + max_new_tokens} exceeds block_size {model.cfg.block_size}")
    max_seq = t + max_new_tokens + draft_len + 1
    cache = model.init_cache(b, max_seq, quantize=kv_quant)
    first = model.prefill(prompt_ids, prompt_lengths, cache).argmax(dim=-1)
    tokens = torch.zeros((b, max_seq), dtype=torch.long, device=device)
    tokens[:, :t] = prompt_ids
    done = (torch.zeros(b, dtype=torch.bool, device=device) if eos_id is None
            else first == eos_id)
    tokens[torch.arange(b, device=device), prompt_lengths] = torch.where(done, 0, first)
    emitted = (~done).long()
    return (tokens, prompt_lengths + emitted, emitted, cache, done, first, 0), t


def _run_speculative(state, step, t: int, max_new_tokens: int, return_steps: bool):
    """`step` until every row is done or has its max_new_tokens (one flag
    read a verify step); the return of `generate_lookup`."""
    while bool((~state[4] & (state[2] < max_new_tokens)).any()):
        state = step(state)
    tokens, lengths, emitted = state[0][:, :t + max_new_tokens], state[1], state[2]
    if return_steps:
        return tokens, lengths, (state[6], emitted)
    return tokens, lengths


@torch.no_grad()
def generate_lookup(model: GPT, prompt_ids, prompt_lengths, *, max_new_tokens: int = 150,
                    eos_id: Optional[int] = None, draft_len: int = 8, ngram: int = 3,
                    return_steps: bool = False, kv_quant: Optional[str] = None):
    """Greedy decoding with prompt-lookup speculative drafting
    (`generate_lookup` of the JAX package). GER output mostly copies the
    prompt's best hypothesis, so drafting the continuation of the last
    `ngram` tokens' latest occurrence and verifying the drafts and a bonus
    token in one `verify_step` emits several tokens a pass over the
    weights. Token-identical to `generate(..., top_k=1)`.

    Returns (tokens (B, T + max_new_tokens), total_lengths (B,)), EOS not
    counted, as `generate`; with return_steps also (verify steps, emitted
    tokens (B,)). Reads one flag a verify step."""
    state, t = _start_speculative(model, prompt_ids, prompt_lengths,
                                  max_new_tokens=max_new_tokens, draft_len=draft_len,
                                  eos_id=eos_id, kv_quant=kv_quant)

    def step(state):
        return lookup_step(model, state, draft_len=draft_len, ngram=ngram, eos_id=eos_id,
                           max_new_tokens=max_new_tokens)

    return _run_speculative(state, step, t, max_new_tokens, return_steps)


@torch.no_grad()
def generate_anchored(model: GPT, prompt_ids, prompt_lengths, span_start, span_len, *,
                      max_new_tokens: int = 150, eos_id: Optional[int] = None,
                      draft_len: int = 8, ngram: int = 3, return_steps: bool = False,
                      kv_quant: Optional[str] = None):
    """`generate_lookup` with hypothesis-anchored, monotone-pointer drafting
    (`generate_anchored` of the JAX package). span_start, span_len (B,):
    each prompt's best-hypothesis token span (`find_subsequence_span`); a
    zero span degrades to the suffix lookup. Token-identical to
    `generate(..., top_k=1)`: drafting changes only the acceptance."""
    state, t = _start_speculative(model, prompt_ids, prompt_lengths,
                                  max_new_tokens=max_new_tokens, draft_len=draft_len,
                                  eos_id=eos_id, kv_quant=kv_quant)
    span_start = torch.as_tensor(span_start, device=model.device).long()
    span_len = torch.as_tensor(span_len, device=model.device).long()
    state = state + (torch.zeros_like(span_start),)

    def step(state):
        return anchored_step(model, state, span_start, span_len, draft_len=draft_len,
                             ngram=ngram, eos_id=eos_id, max_new_tokens=max_new_tokens)

    return _run_speculative(state, step, t, max_new_tokens, return_steps)


def find_subsequence_span(prompt_ids, sub_ids):
    """Host helper: (start, len) of the FIRST occurrence of `sub_ids` inside
    `prompt_ids` (lists or 1-D arrays); (0, 0) if absent or empty, where
    `generate_anchored` degrades to the suffix lookup."""
    prompt = list(prompt_ids)
    sub = list(sub_ids)
    if not sub or len(sub) > len(prompt):
        return 0, 0
    for i in range(len(prompt) - len(sub) + 1):
        if prompt[i:i + len(sub)] == sub:
            return i, len(sub)
    return 0, 0
