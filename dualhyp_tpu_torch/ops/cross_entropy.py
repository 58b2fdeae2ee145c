"""Cross entropy with ignore-index and sequence chunking.

A copy of `dualhyp_tpu/ops/cross_entropy.py` in PyTorch, quirks included:
the mean over non-ignored (-1) targets; `mean_all_tokens=True` divides the
summed loss by every position, ignored ones too (the reference's training
normalisation, ref: ger/utils.py:440-447); the chunked path runs only when
T % chunk_size == 0 (the trainer hands it T - 1 positions, so the
full-logits path is the usual one); logits are computed in the hidden
states' dtype and then upcast.
"""

from __future__ import annotations

import torch

IGNORE_INDEX = -1


def _token_ce(logits, targets):
    """Per-token CE with the ignore mask. logits (..., V), targets (...)."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    gathered = logits.gather(-1, targets.clamp_min(0).long()[..., None])[..., 0]
    mask = targets != IGNORE_INDEX
    return torch.where(mask, logz - gathered, 0.0), mask


def cross_entropy(logits, targets, mean_all_tokens: bool = False):
    """Mean CE over non-ignored targets (== F.cross_entropy(ignore_index=-1));
    `mean_all_tokens` divides by targets.numel() instead."""
    nll, mask = _token_ce(logits, targets)
    denom = mask.numel() if mean_all_tokens else mask.sum().clamp_min(1)
    return nll.sum() / denom


def chunked_cross_entropy(hidden, lm_head_w, targets, chunk_size: int = 128,
                          lm_head_b=None, mean_all_tokens: bool = False):
    """CE(lm_head(hidden), targets), the logits computed chunk by chunk of
    the sequence when T % chunk_size == 0, else all at once.

    hidden: (B, T, D) final (normed) hidden states; lm_head_w: (V, D)
    torch-layout head weight; targets: (B, T) with IGNORE_INDEX masking."""
    t = hidden.shape[1]
    w = lm_head_w.to(hidden.dtype)
    if chunk_size <= 0 or t % chunk_size != 0:
        logits = hidden @ w.t()
        if lm_head_b is not None:
            logits = logits + lm_head_b
        return cross_entropy(logits, targets, mean_all_tokens)
    total = count = 0
    for start in range(0, t, chunk_size):
        logits = hidden[:, start:start + chunk_size] @ w.t()
        if lm_head_b is not None:
            logits = logits + lm_head_b
        nll, mask = _token_ce(logits, targets[:, start:start + chunk_size])
        total = total + nll.sum()
        count = count + mask.sum()
    if mean_all_tokens:
        return total / targets.numel()
    return total / count.clamp_min(1)
