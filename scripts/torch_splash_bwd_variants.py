#!/usr/bin/env python3
"""L1's gradient kernels (splash dQ and dK/dV) of the PyTorch port, built in
variants and timed on one CUDA card.

    python3 scripts/torch_splash_bwd_variants.py [--root DIR ...] [--edit "OLD=>NEW" ...]

For each checkout named by `--root` (this one by default; another, such as
the parent commit unpacked under `build/`, takes the same wrappers), one
child process builds the checkout's attention kernels (`flash_attention.cu`,
`flash_attention_bwd.cu` and, where the checkout has it,
`splash_attention.cu`) from a copy of its `csrc/` with each `--edit` made
(OLD must occur exactly once in those sources: a variant of the design,
such as exp2f in place of the SFU's exp), then prints one JSON line: each
gradient instance's registers and spills (`-Xptxas -v`); `splash_dq` and
`splash_dkv` against their plain versions under chip_smoke.FLASH_BWD_TOL at
T 1, 63, 64, 65, 127, 128, 129, 192, 256 and 1024 (B2 Hq16, head sizes 64
and 128, 4 and 8 KV groups, q rounded with the bf16 scale at T % 128 == 0
and the raw q and scale elsewhere), two calls bitwise equal; and at
chip_smoke.SPLASH_SHAPES the device ms of each (one call after an L2
flush, 20 calls) beside SDPA's GQA backward and K1's backward, with the
bound. Only numbers inside one call compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

SOURCES = ("errors.cu", "flash_attention.cu", "flash_attention_bwd.cu", "splash_attention.cu")
CHECK_T = (1, 63, 64, 65, 127, 128, 129, 192, 256, 1024)


def edited_sources(csrc: Path, out: Path, edits: list[str]) -> Path:
    """A copy of `csrc` in `out` with each "OLD=>NEW" edit made once."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for edit in edits:
        old, new = edit.split("=>", 1)
        hits = [p for p in sorted(out.glob("*.cu")) if p.name in SOURCES for _ in
                range(p.read_text().count(old))]
        if len(hits) != 1:
            raise ValueError(f"edit {old!r} matches {len(hits)} places, not one")
        hits[0].write_text(hits[0].read_text().replace(old, new))
    return out


def child(root: Path, edits: list[str]) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dualhyp_tpu_torch.ops import _lib, attention, splash

    # a library of these sources alone, kept apart from the checkout's own
    _lib.BUILD_ROOT = _lib.BUILD_ROOT.parent / "splash_bwd_variants"
    _lib.CSRC = edited_sources(_lib.CSRC, _lib.BUILD_ROOT / "src", edits)
    _lib._sources = lambda: [p for p in sorted(_lib.CSRC.glob("*.cu")) if p.name in SOURCES]
    _lib.build(verbose=True)
    ptxas = {}
    for src in ("flash_attention.cu", "flash_attention_bwd.cu", "splash_attention.cu"):
        ptxas.update(cs.ptxas_report(src) or {})
    # ptxas's notes on wgmma serialization and other warnings, by source
    warnings = {src: sorted({line.strip() for line in log.splitlines()
                             if "arning" in line or "wgmma" in line})
                for src, log in _lib.BUILD_LOGS.items()}
    out = {"root": str(root), "edits": edits, "ptxas": {
        k: v for k, v in ptxas.items() if k.startswith(("splash_", "flash_bwd"))},
        "warnings": {k: v for k, v in warnings.items() if v}}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def inputs(b, hq, g, t, d):
        scale = d ** -0.5
        q, k, v, do = randn(b, hq, t, d), randn(b, g, t, d), randn(b, g, t, d), randn(b, hq, t, d)
        if splash.aligned(t):
            q, scale = q * torch.tensor(scale, dtype=torch.bfloat16), 1.0
        o, lse = splash.splash_fwd(q, k, v, scale)
        return (q, k, v, lse, do, splash.row_dot(o, do), scale), o

    failures, worst = [], 0.0
    for d in (64, 128):
        for g in (4, 8):
            for t in CHECK_T:
                args, _ = inputs(2, 16, g, t, d)
                for name, fn, plain in (("dq", splash.splash_dq, splash.splash_dq_plain),
                                        ("dkv", splash.splash_dkv, splash.splash_dkv_plain)):
                    got, again, want = fn(*args), fn(*args), plain(*args)
                    got, again, want = ((x,) if torch.is_tensor(x) else x
                                        for x in (got, again, want))
                    for x, y, z in zip(got, again, want):
                        try:
                            worst = max(worst, cs.compare_scaled(
                                f"{name} T{t} D{d} G{g}", x, z, torch)["worst_err_over_tol"])
                        except RuntimeError as e:
                            failures.append(str(e)[:300])
                        if not torch.equal(x, y):
                            failures.append(f"{name} T{t} D{d} G{g}: two calls differ")
    out["check"] = {"failures": failures[:20], "n_failures": len(failures),
                    "worst_err_over_tol": worst}

    times = {}
    for label, b, nh, g, t, hs in cs.SPLASH_SHAPES:
        args, o = inputs(b, nh, g, t, hs)
        q, k, v, lse, do, di, scale = args
        pairs = b * nh * t * (t + 1) // 2
        n_q, n_kv, n_rows = b * nh * t * hs, b * g * t * hs, b * nh * t
        row = {}
        for name, fn, plain, n_bytes, flops in (
                ("dq", splash.splash_dq, splash.splash_dq_plain,
                 (3 * n_q + 2 * n_kv) * 2 + 2 * n_rows * 4, 6 * hs * pairs),
                ("dkv", splash.splash_dkv, splash.splash_dkv_plain,
                 (2 * n_q + 4 * n_kv) * 2 + 2 * n_rows * 4, 8 * hs * pairs)):
            got, want = fn(*args), plain(*args)
            got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
            torch.cuda.synchronize()
            # a timing-only build disagrees: its error is reported, not raised
            err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
            del got, want
            bms, by = cs.bound(n_bytes, flops, cs.BF16_TENSOR_FLOPS)
            row[name] = {"device_ms": cs.device_ms(lambda: fn(*args), torch),
                         "ms": cs.time_ms(lambda: fn(*args), torch), "bound_ms": bms,
                         "bound_by": by, "max_abs_err": err}
        row["pair_device_ms"] = row["dq"]["device_ms"] + row["dkv"]["device_ms"]
        qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
        sdpa_out = cs.sdpa_gqa(F, qr, kr, vr, scale)
        row["sdpa_bwd_ms"] = cs.time_ms(
            lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do, retain_graph=True), torch)
        if t >= 1024:
            row["k1_bwd_device_ms"] = cs.device_ms(
                lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale), torch)
        times[label] = row
        del args, q, k, v, lse, do, di, o, qr, kr, vr, sdpa_out
        torch.cuda.empty_cache()
    out["times"] = times
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None,
                        help="a checkout to build (repeatable; default: this one)")
    parser.add_argument("--edit", action="append", default=[],
                        help='"OLD=>NEW": a text edit of the kernel sources (repeatable)')
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    roots = [Path(r).resolve() for r in (args.root or [Path(__file__).resolve().parents[1]])]
    if args.child:
        print(json.dumps(child(roots[0], args.edit)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    rc = 0
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--root", str(root),
             *(f"--edit={e}" for e in args.edit)], cwd=root, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            rc = 1
            print(json.dumps({"root": str(root), "edits": args.edit, "rc": proc.returncode,
                              "stderr": proc.stderr[-3000:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
