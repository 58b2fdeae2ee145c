#!/usr/bin/env python3
"""K1's backward and L1's dK/dV at head sizes 80 and 96 (phi-2, Phi-3) of
the PyTorch port on one CUDA card, in variants of csrc/flash_attention_bwd.cu.

    python3 scripts/torch_flash_bwd_variants.py [--edits JSON ...]

For this checkout's sources and each `--edits` (a JSON list of "OLD=>NEW",
OLD occurring once in csrc/flash_attention_bwd.cu; the copy is built apart
from the checkout's library, in a child process of its own), one JSON line
a variant: the registers and spills of `flash_bwd_kernel` and `splash_dkv`
at 80 and 96 (`-Xptxas -v`), then at B8 Hq32 G32 T1024 (phi-2's training
shape) and each head size, K1's backward and L1's dK/dV against their plain
versions (chip_smoke.compare_scaled's worst ratio of error to tolerance and
relative L2 error; a variant that breaks the arithmetic is timed all the
same, its error shown) and their device ms (one call after an L2 flush),
beside SDPA's backward (back to back). For example the dQ partials reduced
by each warpgroup apart:

    --edits '["constexpr bool kMergeDq = kWithDq && kTc > 0 && kWG == 2;=>constexpr bool kMergeDq = false;"]'

The card's name and power limit come first; only numbers inside one call
compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def edited_sources(edits: list[str], tag: str) -> Path:
    dst = ROOT / "build" / "flash_bwd_variants" / tag / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "dualhyp_tpu_torch" / "csrc", dst)
    path = dst / "flash_attention_bwd.cu"
    src = path.read_text()
    for edit in edits:
        old, new = edit.split("=>")
        if src.count(old) != 1:
            raise SystemExit(f"edit {old!r} does not occur once")
        src = src.replace(old, new)
    path.write_text(src)
    return dst


def child(csrc: str | None, seed: int) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dualhyp_tpu_torch.ops import _lib, attention, splash

    if csrc:
        _lib.CSRC = Path(csrc)
        _lib.BUILD_ROOT = Path(csrc).parent / "lib"
    _lib.build(verbose=True)
    report = cs.ptxas_report("flash_attention_bwd.cu") or {}
    out = {"ptxas": {k: v for k, v in report.items() if "<80" in k or "<96" in k}}
    cs.warm_up(torch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, nh, t = 8, 32, 1024
    for hs in (80, 96):
        scale = 1.0 / math.sqrt(hs)
        q, k, v, do = (torch.randn(b, nh, t, hs, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = attention._flash_fwd(q, k, v, scale)
        so, slse = splash.splash_fwd(q, k, v, scale)
        args = (q, k, v, slse, do, splash.row_dot(so, do), scale)
        runs = {"flash_attention_bwd": (
                    lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale),
                    lambda: attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale),
                    "qkv"),
                "splash_attention_dkv": (lambda: splash.splash_dkv(*args),
                                         lambda: splash.splash_dkv_plain(*args), "kv")}
        for name, (fn, plain, parts) in runs.items():
            errs = {}
            for part, x, y in zip(parts, fn(), plain()):
                x, y = x.float(), y.float()
                try:
                    errs[f"d{part}"] = cs.compare_scaled(name, x, y, torch)
                except RuntimeError as err:
                    errs[f"d{part}"] = {"error": str(err)[-200:],
                                        "rel_l2_err": float((x - y).norm() / y.norm())}
            out[f"{name}_d{hs}"] = {**errs, "device_ms": cs.device_ms(fn, torch, iters=5)}
        qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
        sdpa_out = cs.sdpa_gqa(F, qr, kr, vr, scale)
        out[f"sdpa_bwd_ms_d{hs}"] = cs.time_ms(
            lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do, retain_graph=True), torch,
            iters=5)
        del q, k, v, do, o, lse, so, slse, args, qr, kr, vr, sdpa_out
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--edits", action="append", default=[])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--csrc", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.csrc, args.seed)
        return 0
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    for i, edits in enumerate([[]] + [json.loads(e) for e in args.edits]):
        print(json.dumps({"variant": i, "edits": edits}), flush=True)
        cmd = [sys.executable, __file__, "--child", "--seed", str(args.seed)]
        if edits:
            cmd += ["--csrc", str(edited_sources(edits, f"v{i}"))]
        rc = subprocess.run(cmd, env=dict(os.environ), stderr=subprocess.DEVNULL).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
