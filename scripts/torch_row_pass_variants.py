#!/usr/bin/env python3
"""K2 (RMSNorm) and K3 (RoPE) of the PyTorch port, timed on one CUDA card in
variants of their launch.

    python3 scripts/torch_row_pass_variants.py [--root DIR] [--flags=-DX=1,...] \\
        [--blocks-per-sm 3,6,12] [--reps 2] [--read-twice]

Builds the kernel library of the checkout `--root` (this one by default;
another, such as the parent commit unpacked under `build/`, takes the same
wrappers) with `--flags` appended to nvcc's (a variant the sources select
by macro), keeps the card busy for two seconds (`chip_smoke.warm_up`; the
measuring code is always this checkout's `chip_smoke.py`), then prints one
JSON line:
- the registers and spills of `rmsnorm.cu` and `rope.cu` (`-Xptxas -v`);
- K2 at 8, 3072 and 8192 rows of width 2048 and 8192 rows of 4096 (bf16):
  its device ms, `F.rms_norm`'s and a copy's of the same input (`clone`:
  the same bytes moved) and, with `--read-twice`, those of its loop that
  reads each row twice, all with the L2 cache evicted before each call
  (`chip_smoke.device_ms`), `--reps` times in turns, beside the byte bound;
  and K2's `warm_ms`: one call right after another on the same inputs (L2
  warm: inputs, code and arguments cached);
- K3 forward and transposed at TinyLlama's prefill q (8 x 384) and its
  and Mixtral's training q and k (8 x 1024), q and k read in place from a
  fused QKV: device ms for each `ops.rope.BLOCKS_PER_SM` in
  `--blocks-per-sm` (the grid the wrapper aims at; a checkout without
  that knob is timed as it is), beside the byte bound.
Each kernel is first checked against its plain version (chip_smoke's
tolerances). Only numbers inside one call compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def warm_ms(fn, torch, iters: int = 20) -> float:
    """Device ms of one call of `fn` right after another on the same inputs
    (CUDA events around each call alone; a spin of the card, which touches
    no memory, covers the host's enqueue)."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in events:
        fn()
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def _with(module, name, value, fn):
    """fn() with module.name set to value."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn()
    finally:
        setattr(module, name, old)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="the checkout whose package and kernels are timed")
    parser.add_argument("--flags", default="", help="nvcc flags, comma-separated")
    parser.add_argument("--blocks-per-sm", default="3",
                        help="values of ops.rope.BLOCKS_PER_SM, comma-separated")
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--read-twice", action="store_true",
                        help="also time K2's loop that reads each row twice")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import importlib.util

    import torch
    import torch.nn.functional as F

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from dualhyp_tpu_torch.config import GPTConfig
    from dualhyp_tpu_torch.models.gpt import split_heads
    from dualhyp_tpu_torch.ops import _lib, rmsnorm, rope

    if not torch.cuda.is_available():
        print("torch_row_pass_variants: no CUDA device is available", file=sys.stderr)
        return 2
    flags = [f for f in args.flags.split(",") if f]
    _lib.NVCC_FLAGS = (*_lib.NVCC_FLAGS, *flags)
    _lib.build(verbose=True)
    out = {"device": cs.nvidia_smi_line(), "root": str(args.root), "flags": flags,
           "ptxas": {src: cs.ptxas_report(src) for src in ("rmsnorm.cu", "rope.cu")},
           "warm_up": cs.warm_up(torch, seconds=2.0)}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rms = {}
    for rows, d in ((8, 2048), (3072, 2048), (8192, 2048), (8192, 4096)):
        x = randn(rows, d)
        scale = 1.0 + 0.1 * randn(d, dtype=torch.float32)
        scale_bf16 = scale.to(bf16)
        cs.compare("rms_norm", rmsnorm.rms_norm(x, scale), rmsnorm.rms_norm_plain(x, scale),
                   torch)
        row = {"bound_ms": cs.bound(2 * rows * d * 2 + d * 4, 4 * rows * d, cs.FP32_FLOPS)[0]}
        calls = {"device_ms": lambda: rmsnorm.rms_norm(x, scale),
                 "library_device_ms": lambda: F.rms_norm(x, (d,), scale_bf16, 1e-5),
                 "copy_device_ms": x.clone}
        calls["warm_ms"] = None
        if args.read_twice:  # the loop that reads the row twice, at 16-byte vectors
            plan = rmsnorm.row_plan
            calls["read_twice_device_ms"] = lambda: _with(
                rmsnorm, "row_plan", lambda *a: (plan(*a)[0], 0, plan(*a)[2], 1),
                lambda: rmsnorm.rms_norm(x, scale))
        for _ in range(args.reps):
            for key, fn in calls.items():
                row.setdefault(key, []).append(
                    warm_ms(calls["device_ms"], torch) if fn is None else cs.device_ms(fn, torch))
        rms[f"{rows}x{d}"] = row
    out["rms_norm"] = rms

    cases = {}
    for model, n_embd, groups, hs, base, t in (("tinyllama_prefill", 2048, 4, 64, 10000, 384),
                                               ("tinyllama", 2048, 4, 64, 10000, 1024),
                                               ("mixtral", 4096, 8, 128, 1000000, 1024)):
        cfg = GPTConfig(n_embd=n_embd, n_head=32, n_query_groups=groups,
                        intermediate_size=256, mlp_class="LLaMAMLP", rope_base=base)
        q5, k4, _ = split_heads(cfg, randn(8, t, cfg.qkv_out_dim))
        cos, sin = rope.build_rope_cache(t, hs, base=base, dtype=bf16, device="cuda")
        views = {"q": q5, "k": k4} if t == 1024 else {"q": q5}
        for name, view in views.items():
            grad = randn(*view.shape)
            for label, xin, tr in (("forward", view, False), ("transpose", grad, True)):
                cs.compare("apply_rope", rope.apply_rope(xin, cos, sin, tr),
                           rope.apply_rope_plain(xin, cos, sin, tr), torch)
                cases[f"{model}_{name}_{label}"] = (xin, tr, cos, sin)
    default = getattr(rope, "BLOCKS_PER_SM", None)
    ropes = {}
    for key, (xin, tr, cos, sin) in cases.items():
        n = xin.numel()
        row = {"shape": list(xin.shape),
               "bound_ms": cs.bound(4 * n + 4 * cos.numel(), 4 * n, cs.FP32_FLOPS)[0]}
        values = [int(v) for v in args.blocks_per_sm.split(",")] if default else [None]
        for value in values:
            if value:
                rope.BLOCKS_PER_SM = value
            row[f"blocks_per_sm_{value}" if value else "as_is"] = [
                cs.device_ms(lambda: rope.apply_rope(xin, cos, sin, tr), torch)
                for _ in range(args.reps)]
        if default:
            rope.BLOCKS_PER_SM = default
        ropes[key] = row
    out["apply_rope"] = ropes
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
