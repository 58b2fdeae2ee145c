"""Joint CTC/attention beam search (ESPnet-style) returning n-best.

Capability parity with the vendored BatchBeamSearch the reference drives for
VSR/AVSR hypothesis generation (ref: data/raven/espnet/nets/beam_search.py,
batch_beam_search.py; wired in data/raven/finetune_learner.py:50-109):

  hypothesis score = w_dec * logP_attention + w_ctc * logPsi_CTC
                   + w_lm * logP_LM + w_len * length

Per step: full scorers (attention decoder, LM, length bonus) evaluate the
whole vocabulary; the CTC prefix scorer — a partial scorer — evaluates only
the `pre_beam` best candidates under the full-scorer sum (ESPnet's
pre-beam), and the joint top `beam_size` candidates survive. Finished
hypotheses (EOS) leave the beam; search ends when the beam empties or
max_len is reached. Returns all finished hypotheses sorted by score
(the n-best the reference's get_nbest_hyps consumes).

Counterpart of `dualhyp_tpu/infer/joint_beam_search.py`: the search is the
JAX package's host numpy, copied. Its attention scorer here is
`full_forward_att_fn`, the decoder's full forward at the last position;
`static_shape_att_fn`'s jit buckets have no counterpart (eager PyTorch
compiles nothing). `make_json_vsr` and `make_json_avsr` retry a batch that
failed one utterance at a time with it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dualhyp_tpu_torch.device import exact_fp32
from dualhyp_tpu_torch.infer.ctc_prefix import CTCPrefixScorer
from dualhyp_tpu_torch.models import espnet_decoder as ed


@dataclass
class JointHypothesis:
    tokens: List[int]          # includes leading sos
    score: float
    ctc_state: object = None
    ctc_score: float = 0.0

    def result_tokens(self, sos, eos):
        return [t for t in self.tokens if t not in (sos, eos)]


def joint_beam_search(
    att_logprobs_fn: Callable,
    ctc_scorer: Optional[CTCPrefixScorer],
    *,
    sos: int,
    eos: int,
    beam_size: int = 40,
    weights: Optional[Dict[str, float]] = None,
    max_len: int = 100,
    lm_logprobs_fn: Optional[Callable] = None,
    pre_beam_ratio: float = 1.5,
    blank: int = 0,
) -> List[JointHypothesis]:
    """att_logprobs_fn(tokens (B, T) int32) -> (B, V) log-softmax of the
    attention decoder; lm_logprobs_fn likewise for the LM."""
    weights = {
        "decoder": 0.5,
        "ctc": 0.5,
        "lm": 0.0,
        "length_bonus": 0.0,
        **(weights or {}),
    }
    pre_beam = int(pre_beam_ratio * beam_size)

    init_ctc = ctc_scorer.initial_state() if ctc_scorer is not None else None
    live = [JointHypothesis([sos], 0.0, ctc_state=init_ctc)]
    finished: List[JointHypothesis] = []

    for _ in range(max_len):
        if not live:
            break
        tokens = np.asarray([h.tokens for h in live], np.int32)
        att = np.asarray(att_logprobs_fn(tokens))  # (B, V)
        lm = (
            np.asarray(lm_logprobs_fn(tokens))
            if lm_logprobs_fn is not None and weights["lm"] != 0.0
            else None
        )
        vocab = att.shape[-1]

        fulls = weights["decoder"] * att
        if lm is not None:
            fulls = fulls + weights["lm"] * lm
        fulls = fulls + weights["length_bonus"]
        if ctc_scorer is not None:
            # blank is an alignment symbol, never an output label — a
            # blank-extended prefix is ill-defined for the CTC scorer
            fulls = fulls.copy()
            fulls[:, blank] = -np.inf

        candidates = []
        if ctc_scorer is not None and weights["ctc"] != 0.0:
            k = min(pre_beam, vocab)
            cand_mat = np.argpartition(-fulls, k - 1, axis=1)[:, :k]  # (H, k)
            psi_mat, state_mat = ctc_scorer.score_batch(
                [h.tokens for h in live],
                cand_mat,
                np.stack([h.ctc_state for h in live]),
            )
            for b, hyp in enumerate(live):
                for j in range(k):
                    c = int(cand_mat[b, j])
                    score = (
                        hyp.score
                        + fulls[b, c]
                        + weights["ctc"] * (float(psi_mat[b, j]) - hyp.ctc_score)
                    )
                    candidates.append(
                        (score, hyp, c, state_mat[b, j], float(psi_mat[b, j]))
                    )
        else:
            k = min(beam_size + 1, vocab)
            cand_mat = np.argpartition(-fulls, k - 1, axis=1)[:, :k]
            for b, hyp in enumerate(live):
                for c in cand_mat[b]:
                    candidates.append(
                        (hyp.score + fulls[b, c], hyp, int(c), None, 0.0)
                    )

        candidates.sort(key=lambda c: -c[0])
        new_live = []
        for score, hyp, tok, ctc_state, psi in candidates[: 2 * beam_size]:
            new = JointHypothesis(
                hyp.tokens + [tok], float(score), ctc_state=ctc_state,
                ctc_score=psi,
            )
            if tok == eos:
                finished.append(new)
            else:
                new_live.append(new)
            if len(new_live) >= beam_size:
                break
        live = new_live
        if len(finished) >= beam_size:
            break

    # surviving unfinished beams also count toward the n-best pool
    finished.extend(live)
    finished.sort(key=lambda h: -h.score / max(len(h.tokens), 1))
    return finished


def full_forward_att_fn(dec_params, dec_cfg, memory):
    """The attention scorer `joint_beam_search` takes, for one utterance's
    memory (S, adim) or (1, S, adim) on the decoder's device: tokens (B, T)
    -> (B, V) fp32 log-softmax of the decoder's full forward at the last
    position (numpy)."""
    mem = memory if memory.dim() == 3 else memory[None]

    def att_fn(tokens):
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int64)).to(mem.device)
        with torch.no_grad(), exact_fp32():
            logits = ed.decode_logits(dec_params, dec_cfg, toks,
                                      mem.expand(toks.shape[0], -1, -1))
            return torch.log_softmax(logits[:, -1].float(), dim=-1).cpu().numpy()

    return att_fn
