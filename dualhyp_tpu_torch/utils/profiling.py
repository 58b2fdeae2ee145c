"""Profiling helpers: a profiler trace, counted FLOPs and the card's memory.

Counterpart of `dualhyp_tpu/utils/profiling.py` (the reference's
FlopCounterMode and torch.cuda memory logs, ref: ger/speed_monitor.py:398-406,
finetune/ger.py:200-205):

  * `trace(log_dir)`: a `torch.profiler` trace of the block (CPU and, where
    a card is present, CUDA activity), written to `log_dir` as a Chrome /
    Perfetto JSON trace;
  * `compiled_flops(fn, *args)`: the FLOPs that run while `fn(*args)`
    runs: those of the aten ops, as `torch.utils.flop_counter.
    FlopCounterMode` counts them (matrix products, attention,
    convolutions), plus those the hand-written kernels' launches declare
    (`ops._lib.FLOP_TALLIES`), which FlopCounterMode cannot see (the JAX
    package asks XLA's cost analysis);
  * `live_device_memory()`: per card, the allocator's bytes in use, their
    peak and the card's total memory (`torch.cuda.memory_stats`); an empty
    dict without a card.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir="dualhyp_trace"):
    """Profile the block with torch.profiler; on exit the trace is written
    to `log_dir` (created) as `trace_<time>.json`. Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(log_dir / f"trace_{time.time_ns()}.json"))


def compiled_flops(fn, *args) -> float:
    """The FLOPs of one call `fn(*args)`: FlopCounterMode's count of its
    aten ops plus the FLOPs of its kernel launches (a training step's
    backward counts too when `fn` runs it, recomputations included)."""
    from torch.utils.flop_counter import FlopCounterMode

    from dualhyp_tpu_torch.ops import _lib

    counter = FlopCounterMode(display=False)
    tally = [0]
    _lib.FLOP_TALLIES.append(tally)
    try:
        with counter:
            fn(*args)
    finally:
        _lib.FLOP_TALLIES.remove(tally)
    return float(counter.get_total_flops() + tally[0])


def live_device_memory() -> dict:
    """{device name: {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}
    for each CUDA card; {} where there is none."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
