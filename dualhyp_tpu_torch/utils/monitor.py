"""Throughput / MFU monitoring.

A copy of `dualhyp_tpu/utils/monitor.py` with the TPU peak table replaced
by the card's: rolling-window tokens/samples/FLOPs per second and MFU
against the dense bf16 tensor-core peak of the card the run is on
(ref: ger/speed_monitor.py:16-406). The analytic FLOPs per token are the
JAX package's formula, so the two packages' MFU read alike.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import torch

# dense bf16 tensor-core peak FLOP/s by card name (NVIDIA's data sheets);
# the longest matching key wins
GPU_PEAK_FLOPS = {
    "h100": 989e12,  # SXM
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
    "h200": 989e12,
}


def gpu_peak_flops(name: Optional[str] = None) -> Optional[float]:
    """Peak of the named card (default: CUDA device 0); None off the card or
    for a card the table lacks."""
    if name is None:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    name = name.lower()
    for key, peak in sorted(GPU_PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if key in name:
            return peak
    return None


def estimate_train_flops_per_token(cfg, seq_len: int) -> float:
    """Analytic fwd+bwd FLOPs per token (ref: ger/speed_monitor.py:365-395).

    fwd ~= 2 * n_params(matmul) + attention term; bwd ~= 2x fwd for full
    training. For PEFT the backward still traverses the full network
    (activations grads) so the 3x multiplier stays — the reference's
    `flops_per_param` convention, which keeps MFU comparable."""
    d, n_layer = cfg.n_embd, cfg.n_layer
    matmul_params = (
        n_layer * (cfg.qkv_out_dim * d + d * d)  # attn qkv + proj
        + n_layer * _mlp_params(cfg)
        + cfg.padded_vocab_size * d  # lm head
    )
    fwd = 2 * matmul_params
    # attention scores+values: 2 matmuls of (T x hs) per head pair
    fwd += 2 * 2 * n_layer * cfg.n_head * cfg.head_size * seq_len
    return 3 * fwd


def _mlp_params(cfg):
    if cfg.mlp_class in ("LLaMAMLP", "GemmaMLP"):
        return 3 * cfg.n_embd * cfg.intermediate_size
    return 2 * cfg.n_embd * cfg.intermediate_size


class SpeedMonitor:
    """Rolling-window tokens/sec/device + MFU. The window's clock is the
    host's at each step's return: a step that does not wait for the card is
    counted when the host is done enqueuing it."""

    def __init__(self, window_size: int = 50, n_devices: int = 1,
                 peak_flops: Optional[float] = None):
        self.window = deque(maxlen=window_size)
        self.n_devices = n_devices
        self.peak_flops = peak_flops if peak_flops is not None else gpu_peak_flops()

    def on_step(self, *, tokens: int, samples: int, flops: float = 0.0):
        self.window.append((time.perf_counter(), tokens, samples, flops))

    def stats(self) -> dict:
        if len(self.window) < 2:
            return {}
        t0 = self.window[0][0]
        t1 = self.window[-1][0]
        elapsed = max(t1 - t0, 1e-9)
        tokens = sum(w[1] for w in list(self.window)[1:])
        samples = sum(w[2] for w in list(self.window)[1:])
        flops = sum(w[3] for w in list(self.window)[1:])
        out = {
            "tokens_per_sec": tokens / elapsed,
            "tokens_per_sec_per_device": tokens / elapsed / self.n_devices,
            "samples_per_sec": samples / elapsed,
            "flops_per_sec": flops / elapsed,
        }
        if self.peak_flops:
            out["mfu"] = flops / elapsed / (self.peak_flops * self.n_devices)
        return out
