"""Whisper beam search with the candidate selection on the card.

Counterpart of `dualhyp_tpu/infer/whisper_device_beam.py`. The Whisper
DecodingTask's beam update rule (BeamSearchDecoder.update, ref:
data/whisper/decoding.py:338-441) runs on the card for U utterances of
`beam_size` rows each, in lockstep: per step one cached decoder step
(`models/whisper.decode_step_cached`), the logit rules (blank at the first
sampled position, suppression, the timestamp rules from three per-row
values carried on the card), a log-softmax, the top (beam + 1) of each row
and the top 2 x beam of each utterance, EOS retirement and the refill of
the beam. Nothing is read back inside a chunk of `chunk_steps` steps: the
host reads the chunk's (steps, 3, U, 2 x beam) scalar pack once and replays
the same deterministic rule over it to rebuild the token lists; the next
chunk is queued before that read, so the card works while the host replays.
The setup's host arrays go to the card from pinned memory, so the chunks'
reads are the search's only host syncs.

The protocol (the JAX package's TPU-shaped formulations have no counterpart
here):
  * the self-attention cache is allocated at the token budget, capped at
    n_ctx, and a row's history follows its parent by index: before a step
    writes its column, the rows' previous columns are re-parented with one
    `index_select` (`models/whisper.reparent`);
  * the prompt's K/V is computed once an utterance by a causal prefill
    (`prefill_cache`) and shared by its rows (`prefix_kv`); ragged prompts
    are right-aligned into one column buffer with per-row position offsets;
  * top-k everywhere breaks ties to the lower index, as `lax.top_k` does
    (`topk_lowest_index`): suppressed tokens, timestamp rules and starved
    beams make -inf ties.

The host replay, the starvation guard and the finalizer are the JAX
package's, line for line.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from dualhyp_tpu_torch.device import to_device
from dualhyp_tpu_torch.infer.beam_search import BeamHypothesis, TimestampRules, cons_to_list
from dualhyp_tpu_torch.models import whisper as w

_NEG = float("-inf")
MULTI_UTT_CHUNK = 16  # steps a chunk when several utterances decode together


def topk_lowest_index(x: torch.Tensor, k: int):
    """The k largest fp32 values along the last axis, sorted, equal values
    in the order of their index (lax.top_k's order): one integer top-k over
    (the value's order-preserving bits << 32) | (n - 1 - index)."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32)
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64) << 32
    key = key | (n - 1 - torch.arange(n, device=x.device))
    idx = torch.topk(key, k, dim=-1).indices
    return x.gather(-1, idx), idx


def _prefill(dec_params, dec_cfg, cross, tokens, offsets, quantize):
    """The prompt's K/V at one row an utterance, laid out as the cross K/V:
    float (k, v) (L, U, H, P, hd), or int8 with one scale a (layer,
    utterance, channel) over the prompt's columns."""
    ks, vs = w.prefill_cache(dec_params, dec_cfg, tokens, cross, pos_offset=offsets)
    l_, u, p, s = ks.shape
    h = dec_cfg.n_head
    ks, vs = (t.view(l_, u, p, h, s // h).permute(0, 1, 3, 2, 4).contiguous()
              for t in (ks, vs))
    if quantize == "int8":
        kq, ksc = w._q8(ks, dim=-2)
        vq, vsc = w._q8(vs, dim=-2)
        return kq.to(torch.int8), ksc, vq.to(torch.int8), vsc
    return ks, vs


def device_beam_search(dec_params, dec_cfg, features, prefix: List[int], **kwargs
                       ) -> List[BeamHypothesis]:
    """`device_beam_search_batch` of one utterance (features (S, n_state) or
    (1, S, n_state))."""
    feats = features if features.dim() == 3 else features[None]
    return device_beam_search_batch(dec_params, dec_cfg, feats, prefix, **kwargs)[0]


def device_beam_search_batch(
    dec_params,
    dec_cfg,
    features,
    prefix: Union[List[int], Sequence[Sequence[int]]],
    *,
    beam_size: int,
    eos_id: int,
    max_new_tokens: int,
    suppress_tokens: Optional[Sequence[int]] = None,
    suppress_blank_ids: Optional[Sequence[int]] = None,
    timestamp_rules: Optional[TimestampRules] = None,
    patience: Optional[float] = None,
    length_penalty: Optional[float] = None,
    cache_dtype=None,
    chunk_steps: Optional[int] = None,
    cross_kv_quant=None,
    self_kv_quant=None,
    stats: Optional[dict] = None,
) -> List[List[BeamHypothesis]]:
    """Beam search over U utterances at once, (U x beam_size) rows a step.

    features: (U, S, n_state) encoder outputs on the card (or the CPU).
    prefix: one shared List[int] or one List[int] an utterance (ragged,
    right-aligned into max(len) columns; an utterance's results equal its
    own run's). chunk_steps: steps between host reads, 16 for U > 1 and the
    whole budget for U = 1 when None. The budget stops where the total
    length passes n_ctx (ref: data/whisper/decoding.py:746). cache_dtype:
    the self cache's dtype, the token embedding's when None.
    cross_kv_quant / self_kv_quant: "int8" K/V (`precompute_cross_kv`,
    `init_self_cache`). stats: a dict that gets the chunks read back, the
    steps run and the steps replayed.

    Returns one List[BeamHypothesis] an utterance, sorted by
    `ranking_score`, as `beam_search_nbest` gives them."""
    device = features.device
    n_utt = features.shape[0]
    rows = n_utt * beam_size
    if chunk_steps is None:
        chunk_steps = MULTI_UTT_CHUNK if n_utt > 1 else max_new_tokens
    per_utt = bool(prefix) and isinstance(prefix[0], (list, tuple, np.ndarray))
    if per_utt:
        prefixes = [list(map(int, p)) for p in prefix]
        if len(prefixes) != n_utt or not all(prefixes):
            raise ValueError(f"{len(prefixes)} prefixes (none empty) for {n_utt} utterances")
        if all(p == prefixes[0] for p in prefixes):
            prefix = prefixes[0]
            per_utt = False
    if per_utt:
        utt_sb = [len(p) for p in prefixes]
        sample_begin = max(utt_sb)
        off_np = np.asarray([sample_begin - n for n in utt_sb], np.int64)
        pmat = np.zeros((n_utt, sample_begin), np.int64)
        for u, p in enumerate(prefixes):
            pmat[u, sample_begin - len(p):] = p
    else:
        prefixes = None
        prefix = list(map(int, prefix))
        sample_begin = len(prefix)
        utt_sb = [sample_begin] * n_utt
        pmat = np.tile(np.asarray(prefix, np.int64), (n_utt, 1))
    if sample_begin > dec_cfg.n_ctx:
        raise ValueError(f"prompt of {sample_begin} tokens for n_ctx {dec_cfg.n_ctx}")
    max_new_tokens = min(max_new_tokens, dec_cfg.n_ctx - sample_begin + 1)
    max_candidates = int(round(beam_size * (patience or 1.0)))
    if max_candidates <= 0:
        raise ValueError(f"invalid beam_size/patience: {beam_size}/{patience}")
    n_vocab = dec_cfg.n_vocab
    k_top = min(beam_size + 1, n_vocab)
    sel_k = min(2 * beam_size, beam_size * k_top)
    if cache_dtype is None:
        cache_dtype = dec_params["token_embedding"].dtype

    cross = w.precompute_cross_kv(dec_params, dec_cfg, features, quantize=cross_kv_quant)
    cache = w.init_self_cache(dec_cfg, rows, max(max_new_tokens, 1), dtype=cache_dtype,
                              quantize=self_kv_quant, device=device)
    row_off = None
    prefix_kv = prefix_valid = None
    if per_utt:
        row_off = to_device(np.repeat(off_np, beam_size), device)
    if sample_begin > 1:
        offsets = to_device(off_np, device) if per_utt else None
        prefix_kv = _prefill(dec_params, dec_cfg, cross,
                             to_device(pmat[:, :-1], device), offsets, self_kv_quant)
        if per_utt:
            prefix_valid = to_device(np.arange(sample_begin - 1)[None, :] >= off_np[:, None],
                                     device)

    def vocab_mask(ids):
        m = np.zeros((n_vocab,), np.float32)
        if ids:
            m[list(ids)] = -np.inf
        return to_device(m, device)

    use_suppress = bool(suppress_tokens)
    use_blank = bool(suppress_blank_ids)
    use_ts = timestamp_rules is not None
    use_ts_static = use_ts and timestamp_rules.no_timestamps is not None
    suppress_mask = vocab_mask(suppress_tokens) if use_suppress else None
    blank_mask = vocab_mask(suppress_blank_ids) if use_blank else None
    ts_static_mask = vocab_mask([timestamp_rules.no_timestamps]) if use_ts_static else None
    tb = timestamp_rules.timestamp_begin if use_ts else 0
    eot = timestamp_rules.eot if use_ts else eos_id
    max_init_idx = timestamp_rules.max_initial_timestamp_index if use_ts else None

    iota = torch.arange(n_vocab, device=device)
    is_ts = iota >= tb
    text_col = iota < eot
    first_mask = iota < tb
    if max_init_idx is not None:
        first_mask = first_mask | (iota > tb + max_init_idx)
    u_of_row = torch.arange(rows, device=device) // beam_size
    row_in_u = torch.arange(rows, device=device) % beam_size
    slot_base = torch.arange(n_utt, device=device)[:, None] * beam_size

    tokens0 = np.zeros((rows, sample_begin + max_new_tokens), np.int64)
    tokens0[:, :sample_begin] = np.repeat(pmat, beam_size, axis=0)
    state = {
        "tokens": to_device(tokens0, device),
        # only row 0 of each utterance is live at the first selection
        "scores": torch.zeros(rows, dtype=torch.float32, device=device),
        "parents": None,  # the rows' parents of the last step, applied at the next
        "lt": torch.zeros(rows, dtype=torch.bool, device=device),  # last is a timestamp
        "pt": torch.ones(rows, dtype=torch.bool, device=device),  # penultimate is (len < 2)
        "has": torch.zeros(rows, dtype=torch.bool, device=device),  # any timestamp yet
        "stamp": torch.zeros(rows, dtype=torch.int64, device=device),  # the last one
        "live": torch.ones(n_utt, dtype=torch.int64, device=device),
        "fin": torch.zeros(n_utt, dtype=torch.int64, device=device),
    }

    def one(step: int):
        st = state
        pos = sample_begin - 1 + step
        is_first = step == 0
        done_prev = (st["fin"] >= max_candidates) | (st["live"] <= 0)
        logits = w.decode_step_cached(
            dec_params, dec_cfg, st["tokens"][:, pos], pos, cache, cross,
            row_gather=st["parents"], pos_offset=row_off, prefix_kv=prefix_kv,
            prefix_valid=prefix_valid, cache_pos=step)
        if use_blank and is_first:
            logits = logits + blank_mask
        if use_suppress:
            logits = logits + suppress_mask
        lt, pt, has, stamp = st["lt"], st["pt"], st["has"], st["stamp"]
        if use_ts:
            if use_ts_static:
                logits = logits + ts_static_mask
            tl = torch.where(has, torch.where(lt & ~pt, stamp, stamp + 1),
                             torch.full_like(stamp, tb))
            mask = (lt & pt)[:, None] & is_ts[None]
            mask |= (lt & ~pt)[:, None] & text_col[None]
            mask |= is_ts[None] & (iota[None] < tl[:, None])
            if is_first:
                mask |= first_mask[None]
            logits = logits.masked_fill(mask, _NEG)
            lp = torch.log_softmax(logits, dim=-1)
            ts_lp = torch.logsumexp(lp[:, tb:], dim=-1)
            max_text = lp[:, :tb].amax(dim=-1)
            logits = logits.masked_fill((ts_lp > max_text)[:, None] & (iota < tb)[None], _NEG)
        logprobs = torch.log_softmax(logits, dim=-1)
        cand_scores, cand = topk_lowest_index(logprobs, k_top)

        # BeamSearchDecoder.update
        total = st["scores"][:, None] + cand_scores
        row_live = row_in_u < st["live"][u_of_row]
        total = total.masked_fill(~row_live[:, None], _NEG)
        sel_scores, sel_flat = topk_lowest_index(total.view(n_utt, beam_size * k_top), sel_k)
        sel_tok = cand.view(n_utt, beam_size * k_top).gather(1, sel_flat)
        valid = torch.isfinite(sel_scores)
        eosm = (sel_tok == eos_id) & valid
        live_c = valid & ~eosm
        l_inc = torch.cumsum(live_c.to(torch.int64), dim=1)
        keep_live = live_c & (l_inc <= beam_size)
        keep_eos = eosm & (l_inc - live_c.to(torch.int64) < beam_size)
        # kept candidates fill the slots in rank order; the rest land in a
        # spare column that is cut off
        dst = torch.where(keep_live, l_inc - 1, torch.full_like(l_inc, beam_size))

        def place(values, fill):
            out = torch.full((n_utt, beam_size + 1), fill, dtype=values.dtype, device=device)
            return out.scatter_(1, dst, values)[:, :beam_size]

        new_parent = place(sel_flat // k_top, 0)
        new_tok = place(sel_tok, 0)
        new_scores = place(sel_scores, _NEG)
        st["live"] = torch.where(done_prev, st["live"],
                                 torch.clamp(l_inc[:, -1], max=beam_size))
        st["fin"] = torch.where(done_prev, st["fin"], st["fin"] + keep_eos.sum(dim=1))

        gparent = (slot_base + new_parent).reshape(-1)
        tokf = new_tok.reshape(-1)
        tokens = st["tokens"].index_select(0, gparent)
        tokens[:, pos + 1] = tokf
        st["tokens"] = tokens
        st["scores"] = new_scores.reshape(-1)
        st["parents"] = gparent
        if use_ts:
            new_lt = tokf >= tb
            st["pt"] = lt[gparent] | is_first
            st["has"] = has[gparent] | new_lt
            st["stamp"] = torch.where(new_lt, tokf, stamp[gparent])
            st["lt"] = new_lt
        return torch.stack([sel_scores, sel_flat.to(torch.float32), sel_tok.to(torch.float32)])

    def dispatch(step0: int, n: int):
        """Queue n steps; their scalar pack stays on the card."""
        return torch.stack([one(step0 + i) for i in range(n)])

    def _root(toks):
        node = None
        for t in toks:
            node = (node, int(t))
        return node

    roots = [_root(p) for p in prefixes] if per_utt else [_root(prefix)] * n_utt
    live: List[List[tuple]] = [[(roots[u], 0.0)] for u in range(n_utt)]
    finished: List[dict] = [{} for _ in range(n_utt)]
    utt_done = [False] * n_utt

    def replay(arr, n):
        """The card's selection rule again, on the host, over the pack."""
        finite = np.isfinite(arr[:, 0])
        parents_all = arr[:, 1].astype(np.int64) // k_top
        toks_all = arr[:, 2].astype(np.int64)
        for s in range(n):
            sel_scores = arr[s, 0]
            for u in range(n_utt):
                if utt_done[u]:
                    continue
                idxs = np.nonzero(finite[s, u])[0]
                sc_l = sel_scores[u][idxs].tolist()
                par_l = parents_all[s, u][idxs].tolist()
                tok_l = toks_all[s, u][idxs].tolist()
                lu = live[u]
                nlu = len(lu)
                fin_u = finished[u]
                new_live: List[tuple] = []
                dropped = 0
                for score, parent, tok in zip(sc_l, par_l, tok_l):
                    if parent >= nlu:
                        dropped += 1
                        continue
                    if tok == eos_id:
                        if len(fin_u) < max_candidates:
                            fin_u.setdefault(tuple(cons_to_list(lu[parent][0])), score)
                    else:
                        new_live.append(((lu[parent][0], tok), score))
                        if len(new_live) == beam_size:
                            break
                # starvation: every candidate of the step is -inf and nothing
                # finished; keep the pre-step beams for the finalizer (ref:
                # data/whisper/decoding.py:389-408)
                if not new_live and not fin_u:
                    if os.environ.get("DUALHYP_BEAM_DEBUG"):
                        print(f"[beam-debug] starved: utt {u} step {s} "
                              f"finite={int(finite[s, u].sum())} parent-dropped={dropped} "
                              f"nlu={nlu}", flush=True)
                    utt_done[u] = True
                    continue
                live[u] = new_live
                if len(fin_u) >= max_candidates or not new_live:
                    utt_done[u] = True

    counters = {"chunks": 0, "steps": 0, "steps_replayed": 0}
    step_done = 0
    pending = None  # (the queued pack, its steps)
    while True:
        if pending is None:
            if step_done >= max_new_tokens or all(utt_done):
                break
            n_steps = min(chunk_steps, max_new_tokens - step_done)
            pending = (dispatch(step_done, n_steps), n_steps)
            step_done += n_steps
        nxt = None
        if step_done < max_new_tokens:
            # the next chunk depends on the card's state only: queue it
            # before this chunk's read, so the card runs during the replay
            n2 = min(chunk_steps, max_new_tokens - step_done)
            nxt = (dispatch(step_done, n2), n2)
            step_done += n2
        ys_k, n_k = pending
        replay(ys_k.cpu().numpy(), n_k)  # the chunk's one host read
        counters["chunks"] += 1
        counters["steps_replayed"] += n_k
        if all(utt_done):
            break
        pending = nxt
    counters["steps"] = step_done
    if stats is not None:
        stats.update(counters)

    out: List[List[BeamHypothesis]] = []
    for u in range(n_utt):
        results = [BeamHypothesis(list(seq), score, utt_sb[u])
                   for seq, score in finished[u].items()]
        if len(results) < beam_size:
            for node, sc in sorted(live[u], key=lambda x: -x[1]):
                results.append(BeamHypothesis(cons_to_list(node), sc, utt_sb[u]))
                if len(results) >= beam_size:
                    break
        results.sort(key=lambda h: -h.ranking_score(length_penalty))
        out.append(results)
    return out
