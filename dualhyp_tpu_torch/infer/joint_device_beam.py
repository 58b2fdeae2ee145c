"""Joint CTC/attention beam search over U utterances, selection on the card.

Counterpart of `dualhyp_tpu/infer/joint_device_beam.py`. The ESPnet joint
beam (`infer/joint_beam_search`; ref: data/raven/espnet/nets/
batch_beam_search.py:30) runs U utterances in lockstep, U x beam rows a
step. Per step, on the card: the cached decoder step
(`models/espnet_decoder.decode_step_cached`), the LM (uncached, its prefix
width bucketed by 16), the full-scorer sum, the `pre_beam` best candidates
of each row, their CTC prefix scores, the fusion, the per-utterance top
2 x beam and the ESPnet fill rule (EOS candidates retire until `beam` live
survivors are taken; a finished utterance freezes its counters). Nothing is
read back inside a chunk: the host reads the chunk's (steps, 4, U, 2 x beam)
scalar pack once, by a non-blocking copy into pinned memory after the next
chunk is queued, and replays the same deterministic rule over it to rebuild
the token lists. The setup's host arrays go up from pinned memory.

The CTC prefix scores (Algorithm 2 of Watanabe et al., the vendored
ctc_prefix_score.py:273-359) take the JAX package's default formulation
(`DUALHYP_CTC_IMPL=assoc`):
  * psi of every candidate from two dense fp32 products per utterance,
    exp(phi[t-1] - row max) (rows, T) times exp(ctc_x - column max)
    (T, V), one for the labels that repeat the prefix's last and one for
    the rest, with the +80-nat low-range rescue for sums that flush to zero;
  * the forward variables (T, 2) only of the rows the step keeps, by the
    affine log-semiring recurrence of `_ctc_recursion_assoc`, run as a
    doubling (Hillis-Steele) scan: ceil(log2 T) passes, not T frame steps.

The products run in full fp32 (TF32 off for the search). Candidate columns
are read by index gathers, where the JAX package reads them through
one-hot products at `Precision.HIGHEST` (a gather is slow on the TPU);
top-k breaks ties to the lower index, as `lax.top_k` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dualhyp_tpu_torch.device import exact_fp32, to_device
from dualhyp_tpu_torch.infer.beam_search import cons_to_list
from dualhyp_tpu_torch.infer.joint_beam_search import JointHypothesis
from dualhyp_tpu_torch.infer.whisper_device_beam import MULTI_UTT_CHUNK, topk_lowest_index
from dualhyp_tpu_torch.models import espnet_decoder as ed
from dualhyp_tpu_torch.models import espnet_lm
from dualhyp_tpu_torch.models.raven import first_leaf_dtype

LOG_ZERO = -1e10
PSI_LO_SHIFT = 80.0
LM_BUCKET = 16  # the LM's prefix width is a multiple of this
_NEG = float("-inf")


def _shift_frames(p):
    """Column t holds p[t-1]; column 0 is LOG_ZERO (never active)."""
    return torch.cat([torch.full_like(p[:, :1], LOG_ZERO), p[:, :-1]], dim=1)


def ctc_probs_shifted(ctc_x):
    """The psi products' hoisted operands: (exp(x - mx), exp(x - mx + 80),
    mx), mx (U, V) the column max over frames. A term flushes only ~88 nats
    below max_t(phi) + max_t(x); the +80 copy rescues sums whose window
    misses the column max (`_ctc_probs_shifted` of the JAX package)."""
    x = ctc_x.float()
    mx = x.amax(dim=1)
    sh = x - mx[:, None, :]
    return torch.exp(sh), torch.exp(sh + PSI_LO_SHIFT), mx


def ctc_psi_scores(ctc_x, ctc_valid_rows, r_prev, last_tokens, cand, out_len: int,
                   blank: int, eos: int, n_hyps_per_utt: int, ctc_probs=None):
    """log psi (R, K) of each row's candidate extensions `cand` (R, K).

    ctc_x (U, T, V) frame log-probs; ctc_valid_rows (R,) each row's valid
    frames; r_prev (R, T, 2) the rows' forward variables [r^n, r^b];
    last_tokens (R,); out_len: tokens emitted so far (lockstep). psi has no
    frame recurrence: the reset seed ⊕ logsumexp over the active frames of
    phi[t-1] + x[t], which in linear space is one (rows, T) x (T, V) product
    per utterance for every label at once. A sum that flushes to zero even
    with the rescue clamps to LOG_ZERO."""
    r_cnt, _ = cand.shape
    n_utt, t_frames, vocab = ctc_x.shape
    h = n_hyps_per_utt
    dev = ctc_x.device
    start = max(out_len, 1)
    t_idx = torch.arange(t_frames, device=dev)
    act = (t_idx[None, :] >= start) & (t_idx[None, :] < ctc_valid_rows[:, None])
    r_sum = torch.logaddexp(r_prev[..., 0], r_prev[..., 1])  # (R, T)
    p_s = _shift_frames(r_sum).masked_fill(~act, _NEG)           # non-repeat
    p_n = _shift_frames(r_prev[..., 1]).masked_fill(~act, _NEG)  # repeat
    probs, probs_lo, col_max = ctc_probs if ctc_probs is not None else ctc_probs_shifted(ctc_x)

    def branch(p):
        m = p.amax(dim=1)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        a = torch.where(torch.isfinite(p), torch.exp(p - m_safe[:, None]), torch.zeros_like(p))
        a = a.view(n_utt, h, t_frames)
        # every label's sum in one product; the candidates' columns read after
        b = torch.bmm(a, probs).view(r_cnt, vocab).gather(1, cand)
        b_lo = torch.bmm(a, probs_lo).view(r_cnt, vocab).gather(1, cand)
        log_b = torch.where(b > 1e-30, torch.log(torch.clamp(b, min=1e-45)),
                            torch.log(torch.clamp(b_lo, min=1e-45)) - PSI_LO_SHIFT)
        return torch.where(b_lo > 0.0, m_safe[:, None] + log_b,
                           torch.full_like(log_b, LOG_ZERO))

    u_of_row = torch.arange(r_cnt, device=dev) // h
    mx_cand = col_max[u_of_row].gather(1, cand)
    val_s = branch(p_s) + mx_cand
    val_n = branch(p_n) + mx_cand
    psi_main = torch.where(cand == last_tokens[:, None], val_n, val_s)
    # the seed r^n[start-1]: x[0] for the empty prefix, LOG_ZERO otherwise
    xs0 = ctc_x[:, 0, :].float()[u_of_row].gather(1, cand)
    seed_on = (out_len == 0) & (ctc_valid_rows > 0)
    seed = torch.where(seed_on[:, None], xs0, torch.full_like(xs0, LOG_ZERO))
    psi = torch.logaddexp(seed, psi_main)
    # eos scores the prefix's total at the last valid frame; blank is never
    # a label (ref: ctc_prefix_score.py:343-350)
    last_valid = torch.clamp(ctc_valid_rows - 1, 0, t_frames - 1)
    r_sum_last = r_sum.gather(1, last_valid[:, None])
    psi = torch.where(cand == eos, r_sum_last.expand_as(psi), psi)
    return psi.masked_fill(cand == blank, LOG_ZERO)


def affine_scan(a, b):
    """Inclusive scan along axis 0 of x[t] = a[t] ⊗ x[t-1] ⊕ b[t] in the log
    semiring (⊗ = +, ⊕ = logaddexp), from x[-1] = -inf: the b component of
    the prefix products, composed as (a1, b1)·(a2, b2) = (a1 + a2,
    b2 ⊕ (a2 + b1)). A doubling (Hillis-Steele) scan: ceil(log2 T) passes
    over the whole axis."""
    t_len = a.shape[0]
    d = 1
    while d < t_len:
        a_prev, b_prev = a[:-d], b[:-d]
        a_cur, b_cur = a[d:], b[d:]
        b = torch.cat([b[:d], torch.logaddexp(b_cur, a_cur + b_prev)])
        a = torch.cat([a[:d], a_prev + a_cur])
        d *= 2
    return b


def ctc_recursion(xs, xb, phi_prev, start: int, valid, out_len: int):
    """The CTC forward recursion of the JAX `_ctc_recursion_assoc`:
    xs, phi_prev (R, T); xb (R, T); valid (R,) -> (r^n, r^b), each (T, R).
    Gating folds into the coefficients: active frames a = x[t], b = x[t] +
    phi[t-1]; before `start` a hard reset (a = -inf, b = the reset value);
    from `valid` on, a carry (a = 0, b = -inf)."""
    t_frames = xs.shape[1]
    dev = xs.device
    t_idx = torch.arange(t_frames, device=dev)[:, None]
    act = (t_idx >= start) & (t_idx < valid[None, :])          # (T, R)
    pre = (t_idx < start).expand_as(act)
    init0 = (t_idx == 0) & (out_len == 0) & (valid[None, :] > 0)
    xs_t, xb_t, phi_t = xs.t().float(), xb.t().float(), phi_prev.t().float()
    neg = torch.full_like(xs_t, _NEG)
    zero = torch.zeros_like(xs_t)
    pre_n = torch.where(init0, xs_t, torch.full_like(xs_t, LOG_ZERO))
    a_n = torch.where(act, xs_t, torch.where(pre, neg, zero))
    b_n = torch.where(act, xs_t + phi_t, torch.where(pre, pre_n, neg))
    rn_all = affine_scan(a_n, b_n)
    rn_prev = torch.cat([torch.full_like(rn_all[:1], LOG_ZERO), rn_all[:-1]])
    a_b = torch.where(act, xb_t, torch.where(pre, neg, zero))
    b_b = torch.where(act, xb_t + rn_prev,
                      torch.where(pre, torch.full_like(xs_t, LOG_ZERO), neg))
    return rn_all, affine_scan(a_b, b_b)


def ctc_history_selected(ctc_x, ctc_valid_rows, r_prev_sel, last_sel, tok, out_len: int,
                         blank: int, n_hyps_per_utt: int):
    """(R, T, 2) forward variables of the selected extensions: row r extends
    its parent's history r_prev_sel[r] (already gathered) by tok[r]."""
    r_cnt = tok.shape[0]
    dev = ctc_x.device
    u_of_row = torch.arange(r_cnt, device=dev) // n_hyps_per_utt
    frames = torch.arange(ctc_x.shape[1], device=dev)
    xs = ctc_x[u_of_row[:, None], frames[None, :], tok[:, None]].float()  # (R, T)
    xb = ctc_x[:, :, blank].float()[u_of_row]
    r_sum = torch.logaddexp(r_prev_sel[..., 0], r_prev_sel[..., 1])
    log_phi = torch.where((tok == last_sel)[:, None], r_prev_sel[..., 1], r_sum)
    rn_all, rb_all = ctc_recursion(xs, xb, _shift_frames(log_phi), max(out_len, 1),
                                   ctc_valid_rows, out_len)
    return torch.stack([rn_all, rb_all], dim=-1).transpose(0, 1)


def _handoff(x) -> bool:
    """The encoder's device handoff: ((U, T_pad, D) tensor, (U,) lengths)."""
    return isinstance(x, tuple) and isinstance(x[0], torch.Tensor) and x[0].dim() == 3


def _bucket(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def joint_device_beam_batch(
    dec_params,
    dec_cfg,
    memories,
    ctc_log_probs,
    *,
    sos: int,
    eos: int,
    beam_size: int = 40,
    weights: Optional[Dict[str, float]] = None,
    max_len: int = 100,
    lm: Optional[Tuple[dict, object]] = None,
    pre_beam_ratio: float = 1.5,
    blank: int = 0,
    mem_pad_multiple: int = 32,
    chunk_steps: Optional[int] = None,
    stats: Optional[dict] = None,
) -> List[List[JointHypothesis]]:
    """The lockstep joint beam over U utterances; an utterance's results are
    `joint_beam_search`'s (the same scores, the same n-best order).

    memories: U (S_i, adim) arrays, or the encoder's handoff ((U, S_pad,
    adim) tensor on the card, (U,) lengths); ctc_log_probs: U (T_i, V)
    arrays, the handoff ((U, T_pad, V), (U,)), or None (attention only).
    lm: (params, EspnetLMConfig) for shallow fusion. chunk_steps: steps
    between host reads, 16 for U > 1 and the whole budget for U = 1 when
    None. stats: a dict that gets the chunks read, the steps run and
    replayed, and the host reads. Runs where the decoder's weights are."""
    weights = {"decoder": 0.5, "ctc": 0.5, "lm": 0.0, "length_bonus": 0.0, **(weights or {})}
    use_ctc = ctc_log_probs is not None and weights["ctc"] != 0.0
    use_lm = lm is not None and weights["lm"] != 0.0
    lm_params, lm_cfg = lm if lm is not None else (None, None)
    device = dec_params["embed"]["weight"].device
    mem_handoff = _handoff(memories)
    n_utt = int(memories[1].shape[0]) if mem_handoff else len(memories)
    if chunk_steps is None:
        chunk_steps = MULTI_UTT_CHUNK if n_utt > 1 else max_len
    h = beam_size
    r_cnt = n_utt * h
    vocab = dec_cfg.odim
    # with CTC: ESPnet's pre-beam; without: the plain top beam+1 expansion
    k_pre = min(int(pre_beam_ratio * beam_size), vocab) if use_ctc else min(beam_size + 1, vocab)

    # memories and CTC frames padded to shared buckets; a handoff's padded
    # tensor is sliced on the card. Frames past a length are never read:
    # mem_len masks the attention, ctc_valid gates every recursion and sum
    if mem_handoff:
        mem_arr, mlens = memories
        mem_len_np = np.asarray(mlens, np.int32)
        s_pad = _bucket(int(mem_len_np.max()), mem_pad_multiple)
        memory = mem_arr[:, :s_pad].float()
    else:
        s_pad = _bucket(max(m.shape[0] for m in memories), mem_pad_multiple)
        mem_np = np.zeros((n_utt, s_pad, memories[0].shape[-1]), np.float32)
        mem_len_np = np.zeros((n_utt,), np.int32)
        for i, m in enumerate(memories):
            mem_np[i, : m.shape[0]] = m
            mem_len_np[i] = m.shape[0]
        memory = to_device(mem_np, device)
    if use_ctc and _handoff(ctc_log_probs):
        ctc_arr, tlens = ctc_log_probs
        ctc_valid_np = np.asarray(tlens, np.int32)
        ctc_x = ctc_arr[:, :_bucket(int(ctc_valid_np.max()), mem_pad_multiple)].float()
    elif use_ctc:
        t_pad = _bucket(max(x.shape[0] for x in ctc_log_probs), mem_pad_multiple)
        ctc_np = np.full((n_utt, t_pad, vocab), LOG_ZERO, np.float32)
        ctc_valid_np = np.zeros((n_utt,), np.int32)
        for i, x in enumerate(ctc_log_probs):
            ctc_np[i, : x.shape[0]] = x
            ctc_valid_np[i] = x.shape[0]
        ctc_x = to_device(ctc_np, device)
    else:
        ctc_x = to_device(np.full((n_utt, 1, vocab), LOG_ZERO, np.float32), device)
        ctc_valid_np = np.ones((n_utt,), np.int32)
    t_frames = ctc_x.shape[1]

    t_buf = max_len + 1
    tokens0 = np.zeros((r_cnt, t_buf), np.int64)
    tokens0[:, 0] = sos
    beam_scores0 = np.full((r_cnt,), -1e30, np.float32)
    beam_scores0[::h] = 0.0  # only row 0 of each utterance is live at step 0
    mem_len = to_device(mem_len_np.astype(np.int64), device)
    valid_u = to_device(ctc_valid_np.astype(np.int64), device)
    valid_rows = valid_u.repeat_interleave(h)
    u_of_row = torch.arange(r_cnt, device=device) // h
    row_in_u = torch.arange(r_cnt, device=device) % h
    slot_base = torch.arange(n_utt, device=device)[:, None] * h
    w_dec, w_ctc, w_lm, penalty = (float(np.float32(weights[k])) for k in
                                   ("decoder", "ctc", "lm", "length_bonus"))

    with torch.no_grad(), exact_fp32():
        if use_ctc:
            # the empty prefix: r^b sums the blanks over the valid frames
            live_t = torch.arange(t_frames, device=device)[None, :] < valid_u[:, None]
            r0b = torch.cumsum(ctc_x[:, :, blank], dim=1).masked_fill(~live_t, LOG_ZERO)
            r0 = torch.stack([torch.full_like(r0b, LOG_ZERO), r0b], dim=-1)
            ctc_probs = ctc_probs_shifted(ctc_x)
        else:
            r0 = torch.full((n_utt, t_frames, 2), LOG_ZERO, device=device)
            ctc_probs = None
        cross_kv = ed.precompute_cross_kv(dec_params, dec_cfg, memory)
        # the self cache in the decoder tree's dtype, as the JAX package keeps it
        cache = ed.init_self_cache(dec_cfg, r_cnt, t_buf, dtype=first_leaf_dtype(dec_params),
                                   device=device)
    pos_table = ed.position_table(dec_cfg, t_buf, device)
    state = {"tokens": to_device(tokens0, device),
             "scores": to_device(beam_scores0, device),
             "ctc_scores": torch.zeros(r_cnt, dtype=torch.float32, device=device),
             "r_live": r0.repeat_interleave(h, dim=0),
             "live": torch.ones(n_utt, dtype=torch.int64, device=device),
             "fin": torch.zeros(n_utt, dtype=torch.int64, device=device)}

    def one(pos: int, t_pad_lm: int):
        st = state
        done_prev = (st["fin"] >= h) | (st["live"] <= 0)
        tokens = st["tokens"]
        last_tokens = tokens[:, pos]
        att_logits, _ = ed.decode_step_cached(dec_params, dec_cfg, last_tokens, pos, cache,
                                              cross_kv, mem_len, pos_table, n_per_group=h)
        fulls = w_dec * torch.log_softmax(att_logits, dim=-1).float()
        if use_lm:
            fulls = fulls + w_lm * espnet_lm.lm_logprobs_at(
                lm_params, lm_cfg, tokens[:, :t_pad_lm], pos).float()
        fulls = fulls + penalty
        if use_ctc:
            fulls[:, blank] = _NEG
        top_vals, cand = topk_lowest_index(fulls, k_pre)  # (R, K)
        if use_ctc:
            psi = ctc_psi_scores(ctc_x, valid_rows, st["r_live"], last_tokens, cand, pos,
                                 blank, eos, h, ctc_probs=ctc_probs)
            total = st["scores"][:, None] + top_vals + w_ctc * (psi - st["ctc_scores"][:, None])
        else:
            psi = torch.zeros_like(top_vals)
            total = st["scores"][:, None] + top_vals
        # dead parent rows produce no candidates
        row_live = row_in_u < st["live"][u_of_row]
        total = total.masked_fill(~row_live[:, None], _NEG)
        sel_scores, sel_flat = topk_lowest_index(total.view(n_utt, h * k_pre), 2 * h)
        sel_tok = cand.view(n_utt, h * k_pre).gather(1, sel_flat)
        sel_psi = psi.view(n_utt, h * k_pre).gather(1, sel_flat)

        # the ESPnet fill rule
        valid = torch.isfinite(sel_scores)
        eosm = (sel_tok == eos) & valid
        live_c = valid & ~eosm
        l_inc = torch.cumsum(live_c.to(torch.int64), dim=1)
        keep_live = live_c & (l_inc <= h)
        keep_eos = eosm & (l_inc - live_c.to(torch.int64) < h)
        # kept candidates fill the slots in rank order; the rest land in a
        # spare column that is cut off
        dst = torch.where(keep_live, l_inc - 1, torch.full_like(l_inc, h))

        def place(values, fill):
            out = torch.full((n_utt, h + 1), fill, dtype=values.dtype, device=device)
            return out.scatter_(1, dst, values)[:, :h].reshape(-1)

        live_flat = place(sel_flat, 0)
        live_tok = place(sel_tok, 0)
        st["live"] = torch.where(done_prev, st["live"], torch.clamp(l_inc[:, -1], max=h))
        st["fin"] = torch.where(done_prev, st["fin"], st["fin"] + keep_eos.sum(dim=1))

        # the selection applied: rows follow their parents
        gparent = (slot_base + (live_flat // k_pre).view(n_utt, h)).reshape(-1)
        tokens = tokens.index_select(0, gparent)
        tokens[:, pos + 1] = live_tok
        st["tokens"] = tokens
        ed.reparent(cache, gparent, pos + 1)
        st["scores"] = place(sel_scores, -1e30)
        if use_ctc:
            st["ctc_scores"] = place(sel_psi, 0.0)
            st["r_live"] = ctc_history_selected(
                ctc_x, valid_rows, st["r_live"].index_select(0, gparent),
                last_tokens.index_select(0, gparent), live_tok, pos, blank, h)
        return torch.stack([sel_scores, sel_flat.float(), sel_tok.float(), sel_psi.float()])

    def dispatch(pos0: int, n: int):
        """Queue n steps and the copy of their scalar pack into pinned host
        memory; returns (pack, event, n)."""
        # the LM's prefix width is bucketed; the decoder steps through its cache
        t_pad_lm = min(_bucket(pos0 + n, LM_BUCKET), t_buf)
        with torch.no_grad(), exact_fp32():
            ys = torch.stack([one(pos0 + i, t_pad_lm) for i in range(n)])
        if device.type != "cuda":
            return ys.numpy(), None, n
        host = torch.empty(ys.shape, dtype=ys.dtype, pin_memory=True)
        host.copy_(ys, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, n

    live: List[List[tuple]] = [[((None, sos), 0.0, 0.0)] for _ in range(n_utt)]
    finished: List[List[JointHypothesis]] = [[] for _ in range(n_utt)]
    utt_done = [False] * n_utt

    def replay(arr, n):
        """The card's selection rule again, on the host, over the pack."""
        finite = np.isfinite(arr[:, 0])
        parents_all = arr[:, 1].astype(np.int64) // k_pre
        toks_all = arr[:, 2].astype(np.int64)
        for s in range(n):
            for ui in range(n_utt):
                if utt_done[ui]:
                    continue
                idxs = np.nonzero(finite[s, ui])[0]
                sc_l = arr[s, 0, ui][idxs].tolist()
                par_l = parents_all[s, ui][idxs].tolist()
                tok_l = toks_all[s, ui][idxs].tolist()
                psi_l = arr[s, 3, ui][idxs].tolist()
                lu = live[ui]
                nlu = len(lu)
                fin_u = finished[ui]
                new_live: List[tuple] = []
                for score, parent_row, tok, psi in zip(sc_l, par_l, tok_l, psi_l):
                    if parent_row >= nlu:
                        continue
                    node = lu[parent_row][0]
                    if tok == eos:
                        fin_u.append(JointHypothesis(cons_to_list(node) + [tok], score,
                                                     ctc_score=psi))
                    else:
                        new_live.append(((node, tok), score, psi))
                    if len(new_live) >= h:
                        break
                live[ui] = new_live
                if len(fin_u) >= beam_size or not new_live:
                    utt_done[ui] = True

    counters = {"chunks": 0, "steps": 0, "steps_replayed": 0, "host_reads": 0}
    step = 0
    pending = None
    while True:
        if pending is None:
            if step >= max_len or all(utt_done):
                break
            n_steps = min(chunk_steps, max_len - step)
            pending = dispatch(step, n_steps)
            step += n_steps
        nxt = None
        if step < max_len:
            # the next chunk depends on the card's state only: queue it
            # before this chunk's read, so the card runs during the replay
            n2 = min(chunk_steps, max_len - step)
            nxt = dispatch(step, n2)
            step += n2
        pack, event, n_k = pending
        if event is not None:
            event.synchronize()  # the chunk's one host read
            pack = pack.numpy()
        counters["host_reads"] += 1
        replay(pack, n_k)
        counters["chunks"] += 1
        counters["steps_replayed"] += n_k
        if all(utt_done):
            break
        pending = nxt
    counters["steps"] = step
    if stats is not None:
        stats.update(counters)

    results: List[List[JointHypothesis]] = []
    for ui in range(n_utt):
        pool = finished[ui] + [JointHypothesis(cons_to_list(node), sc, ctc_score=psi)
                               for node, sc, psi in live[ui]]
        pool.sort(key=lambda hh: -hh.score / max(len(hh.tokens), 1))
        results.append(pool)
    return results
