"""CTC prefix scoring for joint CTC/attention decoding.

A copy of `dualhyp_tpu/infer/ctc_prefix.py` (host numpy): the scorer of the
per-utterance joint beam (`infer/joint_beam_search`).

Implements Algorithm 2 of Watanabe et al., "Hybrid CTC/Attention
Architecture for End-to-End Speech Recognition" (the label-synchronous CTC
prefix probability), vectorised over candidate extensions — the same
algorithm the vendored ESPnet scorer implements
(ref: data/raven/espnet/nets/ctc_prefix_score.py:273-359). Pure numpy,
host-side.

State is the (T, 2) matrix of forward variables [r^n (non-blank-ending),
r^b (blank-ending)] for the current prefix. Scoring a set of candidate
labels `cs` returns log prefix probabilities log psi(prefix + c) and the
per-candidate new states. EOS scores the total probability of the prefix
itself; blank is never a label (scores -inf).
"""

from __future__ import annotations

import numpy as np

LOG_ZERO = -1e10


class CTCPrefixScorer:
    def __init__(self, log_probs: np.ndarray, blank: int = 0,
                 eos: int | None = None, sos: int | None = None):
        self.x = np.asarray(log_probs, np.float32)  # (T, V)
        self.t = self.x.shape[0]
        self.blank = blank
        self.eos = eos if eos is not None else self.x.shape[1] - 1
        self.sos = sos if sos is not None else self.eos

    def initial_state(self) -> np.ndarray:
        r = np.full((self.t, 2), LOG_ZERO, np.float32)
        r[0, 1] = self.x[0, self.blank]
        for i in range(1, self.t):
            r[i, 1] = r[i - 1, 1] + self.x[i, self.blank]
        return r

    def __call__(self, y, cs, r_prev):
        """y: prefix INCLUDING the leading sos; cs: candidate label ids;
        r_prev: (T, 2) state of the prefix. Returns (log_psi (C,),
        r_new (C, T, 2))."""
        cs = np.asarray(cs)
        output_length = len(y) - 1  # sos excluded
        n = len(cs)
        r = np.full((self.t, 2, n), LOG_ZERO, np.float32)
        xs = self.x[:, cs]  # (T, C)
        if output_length == 0:
            r[0, 0] = xs[0]

        r_sum = np.logaddexp(r_prev[:, 0], r_prev[:, 1])  # (T,)
        last = y[-1]
        log_phi = np.broadcast_to(r_sum[:, None], (self.t, n)).copy()
        if output_length > 0:
            repeat = cs == last
            if repeat.any():
                log_phi[:, repeat] = r_prev[:, 1:2]

        start = max(output_length, 1)
        log_psi = r[start - 1, 0].copy()
        x_blank = self.x[:, self.blank]
        for t in range(start, self.t):
            r[t, 0] = np.logaddexp(r[t - 1, 0], log_phi[t - 1]) + xs[t]
            r[t, 1] = np.logaddexp(r[t - 1, 0], r[t - 1, 1]) + x_blank[t]
            log_psi = np.logaddexp(log_psi, log_phi[t - 1] + xs[t])

        eos_pos = np.where(cs == self.eos)[0]
        if len(eos_pos) > 0:
            log_psi[eos_pos] = r_sum[-1]
        blank_pos = np.where(cs == self.blank)[0]
        if len(blank_pos) > 0:
            log_psi[blank_pos] = LOG_ZERO

        return log_psi, np.moveaxis(r, 2, 0)

    def score_batch(self, ys, cs, r_prev):
        """Vectorised across hypotheses: one T-loop for the whole beam
        instead of one per hypothesis (the per-hyp loop dominated the
        joint-beam step time at beam 40).

        ys: list of H prefixes (each including the leading sos), ALL the
        same length (beam search extends every live hypothesis by one
        token per step); cs: (H, C) candidate ids; r_prev: (H, T, 2)
        states. Returns (log_psi (H, C), r_new (H, C, T, 2))."""
        cs = np.asarray(cs)
        h, c = cs.shape
        lengths = {len(y) for y in ys}
        assert len(lengths) == 1, "beam hypotheses must share a length"
        output_length = lengths.pop() - 1  # sos excluded

        r = np.full((self.t, 2, h, c), LOG_ZERO, np.float32)
        xs = self.x[:, cs]  # (T, H, C)
        if output_length == 0:
            r[0, 0] = xs[0]

        r_sum = np.logaddexp(r_prev[:, :, 0], r_prev[:, :, 1])  # (H, T)
        log_phi = np.broadcast_to(
            r_sum.T[:, :, None], (self.t, h, c)
        ).copy()  # (T, H, C)
        if output_length > 0:
            last = np.asarray([y[-1] for y in ys])
            hs, cols = np.where(cs == last[:, None])
            if len(hs) > 0:
                log_phi[:, hs, cols] = r_prev[hs, :, 1].T

        start = max(output_length, 1)
        log_psi = r[start - 1, 0].copy()  # (H, C)
        x_blank = self.x[:, self.blank]
        for t in range(start, self.t):
            r[t, 0] = np.logaddexp(r[t - 1, 0], log_phi[t - 1]) + xs[t]
            r[t, 1] = np.logaddexp(r[t - 1, 0], r[t - 1, 1]) + x_blank[t]
            log_psi = np.logaddexp(log_psi, log_phi[t - 1] + xs[t])

        eos_mask = cs == self.eos
        if eos_mask.any():
            log_psi[eos_mask] = np.broadcast_to(
                r_sum[:, -1][:, None], (h, c)
            )[eos_mask]
        log_psi[cs == self.blank] = LOG_ZERO

        # (T, 2, H, C) -> (H, C, T, 2)
        return log_psi, np.moveaxis(np.moveaxis(r, 2, 0), 3, 1)
