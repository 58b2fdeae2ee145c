"""RelPrompt reliability masks (a copy of `dualhyp_tpu/data/masks.py`).

Frame-level clean/noisy labels from per-sample corruption metadata, chunked
into fixed time windows and binned to `<<C>>` / `<<M>>` / `<<N>>` tokens
with the reference thresholds (clean fraction > 0.9 -> C, < 0.6 -> N,
else M) (ref: data/av_dataset.py:447-500).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

CLEAN, NOISY = "C", "N"
BIN_CLEAN, BIN_MIXED, BIN_NOISY = "<<C>>", "<<M>>", "<<N>>"
CLEAN_THRESHOLD = 0.9
NOISY_THRESHOLD = 0.6


def frame_noise_mask(corruption: dict, mask_threshold: Optional[float] = None
                     ) -> List[str]:
    """Per-frame 'C'/'N' labels from corruption metadata
    {total_len, start_fr, occ_len, snr} (ref: av_dataset.py:447-472).

    When `mask_threshold` is set, the corrupted span only counts as noisy if
    its SNR is below the threshold."""
    total_len = corruption["total_len"]
    start = corruption["start_fr"]
    occ_len = corruption["occ_len"]
    snr = corruption.get("snr", -100)
    mask = [CLEAN] * total_len
    if mask_threshold is None or snr < mask_threshold:
        end = min(start + occ_len, total_len)
        for i in range(start, end):
            mask[i] = NOISY
    return mask


def chunk_reliability(mask: List[str], chunk_size: int,
                      prefix: str = "") -> Tuple[List[float], List[str]]:
    """Per-chunk clean fraction + bin token (ref: av_dataset.py:474-500)."""
    scores, bins = [], []
    for i in range(0, len(mask), chunk_size):
        chunk = mask[i : i + chunk_size]
        score = chunk.count(CLEAN) / len(chunk)
        scores.append(score)
        if score > CLEAN_THRESHOLD:
            bins.append(f"<<{prefix}C>>")
        elif score < NOISY_THRESHOLD:
            bins.append(f"<<{prefix}N>>")
        else:
            bins.append(f"<<{prefix}M>>")
    return scores, bins


def bins_to_indices(bins: List[str], prefix: str = "") -> List[int]:
    """Bin tokens -> class ids {C:0, M:1, N:2} for the classifier CE loss
    (ref: finetune/relprompt.py:73-78)."""
    table = {f"<<{prefix}C>>": 0, f"<<{prefix}M>>": 1, f"<<{prefix}N>>": 2}
    return [table[b] for b in bins]
