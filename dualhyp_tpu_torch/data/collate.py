"""Prompt-length buckets.

A copy of `bucket_length` and `DEFAULT_BUCKETS` from
`dualhyp_tpu/data/collate.py`: a decode batch pads its prompts to the next
bucket boundary, so a handful of prompt shapes cover the whole dataset.
"""

from __future__ import annotations

from typing import Sequence

DEFAULT_BUCKETS = (64, 128, 192, 256, 384, 512, 640, 768, 896, 1024)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
