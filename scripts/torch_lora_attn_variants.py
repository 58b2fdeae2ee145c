#!/usr/bin/env python3
"""K5 (the fused LoRA linear) and the bf16 K6/K7 attention kernel of the
PyTorch port, built in variants and timed on one CUDA card.

    python3 scripts/torch_lora_attn_variants.py [--root DIR ...] [--edit "OLD=>NEW" ...]

For each checkout named by `--root` (this one by default; another, such as
the parent commit unpacked under `build/`, takes the same wrappers), one
child process builds the checkout's kernel library from a copy of its
`csrc/` with each `--edit` made (OLD must occur exactly once in the
sources: a variant of the design), then prints one JSON line:

  * the registers and spills of the K5 and attention kernels (`-Xptxas -v`);
  * K5 against its plain version under chip_smoke.TOLERANCES at rows 1 to
    8192 (ragged O and D, ranks 4 to 64, a separate LoRA input, s of 0,
    0.75 and 2), two calls bitwise equal; then its device ms (one call after
    an L2 flush, 20 calls) at TinyLlama's fused QKV (rank 48) and proj (rank
    16) at the decode (8), fused-slice prefill (1536), 3072 and training
    (8192) rows, with and without a separate LoRA input, beside cuBLAS's
    three products and an add; and at 1 to 128 rows on each of its paths
    (the decode kernel, to 32 rows, the wgmma kernels, and the middle
    kernel where the checkout has it), device ms and host us a call, where
    the checkout has both;
  * K6 and K7 at bf16 against their plain versions (the largest difference
    and the share of elements that differ), and the same for K1's forward
    (which rounds P to bf16) on K7's inputs; their device ms beside SDPA,
    K1's and L1's forwards at K7's shape.

Only numbers inside one call compare. Imports no JAX.
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

LORA_ROWS = (8, 1536, 3072, 8192)
PATH_ROWS = (1, 8, 16, 17, 24, 32, 48, 64, 96, 128)


def edited_sources(csrc: Path, out: Path, edits: list[str]) -> Path:
    """A copy of `csrc` in `out` with each "OLD=>NEW" edit made once."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for edit in edits:
        old, new = edit.split("=>", 1)
        hits = [p for p in sorted(out.glob("*.cu*")) for _ in range(p.read_text().count(old))]
        if len(hits) != 1:
            raise ValueError(f"edit {old!r} matches {len(hits)} places, not one")
        hits[0].write_text(hits[0].read_text().replace(old, new))
    return out


def lora_checks(torch, cs, lora, randn) -> dict:
    failures, worst, repeats = [], 0.0, 0
    atol, rtol = cs.TOLERANCES["lora_linear"]
    cases = [(rows, o, d, r, s, sep)
             for rows in (1, 16, 17, 37, 128, 129, 300, 1536)
             for (o, d) in ((520, 704), (2560, 2048))
             for r in (4, 16, 40, 48, 64) for s in (0.0, 0.75, 2.0) for sep in (False, True)
             if not (o == 2560 and rows > 300 and r != 48)]
    cases += [(8192, 2560, 2048, 48, 1.0, True), (3072, 2048, 2048, 16, 1.0, False)]
    for rows, o, d, r, s, sep in cases:
        x, w = randn(rows, d), randn(o, d, std=0.05)
        a, b = randn(r, d, std=0.05), randn(o, r, std=0.05)
        xin = randn(rows, d) if sep else None
        got, again = (lora.lora_linear(x, w, a, b, s, xin=xin) for _ in range(2))
        want = lora.lora_linear_plain(x, w, a, b, s, xin)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        bound = atol + rtol * want.float().abs()
        worst = max(worst, float((diff / bound).max()))
        label = f"rows {rows} o {o} d {d} r {r} s {s} sep {sep}"
        if not bool((diff <= bound).all()):
            failures.append(f"{label}: max abs err {float(diff.max())}")
        if torch.equal(got, again):
            repeats += 1
        else:
            failures.append(f"{label}: two calls differ")
    return {"cases": len(cases), "failures": failures[:20], "n_failures": len(failures),
            "worst_err_over_tol": worst, "bitwise_repeats": repeats}


def lora_times(torch, cs, lora, randn) -> dict:
    out = {}
    r = cs.LORA_RANK
    for name, o, d, blocks in cs.LORA_SHAPES:
        w = randn(o, d, std=0.02)
        a = randn(blocks * r, d, std=1 / math.sqrt(d))
        b = randn(o, blocks * r, std=0.02)
        for rows in LORA_ROWS:
            for sep in (False, True):
                x = randn(rows, d)
                xin = randn(rows, d) if sep else None
                xb = x if xin is None else xin
                fn = lambda: lora.lora_linear(x, w, a, b, 1.0, xin=xin)  # noqa: E731
                n_x = rows * d * (2 if sep else 1)
                bms, by = cs.bound((n_x + o * d + blocks * r * d + o * blocks * r + rows * o) * 2,
                                   2 * rows * o * d + 2 * rows * blocks * r * (d + o),
                                   cs.BF16_TENSOR_FLOPS)
                out[f"{name}_{rows}{'_xin' if sep else ''}"] = {
                    "device_ms": cs.device_ms(fn, torch), "ms": cs.time_ms(fn, torch),
                    "library_ms": cs.time_ms(lambda: x @ w.t() + (xb @ a.t()) @ b.t(), torch),
                    "bound_ms": bms, "bound_by": by}
        if hasattr(lora, "DECODE_ROWS"):  # every path at 1 to 128 rows
            keep = lora.DECODE_ROWS
            keep_mid = getattr(lora, "MID_ROWS", None)  # the middle kernel (a checkout with one)
            # the decode kernel takes at most 32 rows (the mma.sync tile
            # before it, any)
            most = 32 if hasattr(lora, "decode_plan") else 10 ** 9
            cuts = [("decode", most, keep_mid), ("wgmma", 0, 0)]
            if keep_mid is not None:
                cuts.append(("mid", 0, max(keep_mid, max(PATH_ROWS))))
            for rows in PATH_ROWS:
                x = randn(rows, d)
                fn = lambda: lora.lora_linear(x, w, a, b, 1.0)  # noqa: E731
                row = {}
                for path, cut, mid_cut in cuts:
                    if path != "decode" or rows <= cut:
                        lora.DECODE_ROWS = cut
                        if keep_mid is not None:
                            lora.MID_ROWS = mid_cut
                        row[path] = cs.device_ms(fn, torch)
                        row[f"{path}_host_us"] = cs.host_us(fn, torch)
                lora.DECODE_ROWS = keep
                if keep_mid is not None:
                    lora.MID_ROWS = keep_mid
                row["library_ms"] = cs.time_ms(lambda: x @ w.t() + (x @ a.t()) @ b.t(), torch)
                out[f"{name}_paths_{rows}"] = row
    return out


def attention_rows(torch, F, cs, attention, flash_fwd, splash, randn) -> dict:
    out = {}

    def errors(got, want):
        torch.cuda.synchronize()
        return {"max_abs_err": float((got.float() - want.float()).abs().max()),
                "differ_share": float((got != want).float().mean())}

    plain_k7 = getattr(flash_fwd, "causal_attention_fwd_plain", None)
    plain_k6 = flash_fwd.full_attention_plain
    for label, b, h, t, s_len in (("k6_b8_t1500", 8, 20, 1500, 1500),
                                  ("k6_b2_t300_s1500", 2, 20, 300, 1500),
                                  ("k6_b2_t1500_s77", 2, 20, 1500, 77)):
        q, k, v = randn(b, h, t, 64), randn(b, h, s_len, 64), randn(b, h, s_len, 64)
        fn = lambda: flash_fwd.full_attention_fwd(q, k, v)  # noqa: E731
        row = errors(fn(), plain_k6(q, k, v))
        row.update(device_ms=cs.device_ms(fn, torch),
                   sdpa_ms=cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v), torch),
                   bound_ms=cs.bound((2 * b * h * t * 64 + 2 * b * h * s_len * 64) * 2,
                                     4 * b * h * t * s_len * 64, cs.BF16_TENSOR_FLOPS)[0])
        kv = randn(b, h, s_len, 64)
        row["kv_valid_37"] = errors(flash_fwd.full_attention_fwd(q, kv, v, kv_valid=37),
                                    plain_k6(q, kv, v, kv_valid=37))
        out[label] = row
    for t in (200, 1024, 1500):
        b, hq, g = 8, 32, 4
        q, k, v = randn(b, hq, t, 64), randn(b, g, t, 64), randn(b, g, t, 64)
        want = (plain_k7 or attention.causal_attention_plain)(q, k, v)
        fn = lambda: flash_fwd.causal_attention_fwd(q, k, v)  # noqa: E731
        row = errors(fn(), want)
        k1 = lambda: attention._flash_fwd(q, k, v, 0.125)[0]  # noqa: E731
        row["k1_p_rounded"] = errors(k1(), want)
        ke, ve = (z.repeat_interleave(hq // g, dim=1) for z in (k, v))
        row.update(device_ms=cs.device_ms(fn, torch), k1_fwd_device_ms=cs.device_ms(k1, torch),
                   sdpa_ms=cs.time_ms(lambda: F.scaled_dot_product_attention(
                       q, ke, ve, is_causal=True), torch),
                   bound_ms=cs.bound((2 * b * hq * t * 64 + 2 * b * g * t * 64) * 2,
                                     4 * b * hq * t * (t + 1) // 2 * 64,
                                     cs.BF16_TENSOR_FLOPS)[0])
        if hasattr(splash, "splash_fwd"):
            row["l1_fwd_device_ms"] = cs.device_ms(lambda: splash.splash_fwd(q, k, v, 0.125),
                                                   torch)
        out[f"k7_t{t}"] = row
        del q, k, v, ke, ve
        torch.cuda.empty_cache()
    return out


def child(root: Path, edits: list[str]) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dualhyp_tpu_torch.ops import _lib, attention, flash_fwd, lora, splash

    # a library of these sources, kept apart from the checkout's own
    _lib.BUILD_ROOT = _lib.BUILD_ROOT.parent / "lora_attn_variants"
    _lib.CSRC = edited_sources(_lib.CSRC, _lib.BUILD_ROOT / "src", edits)
    _lib.build(verbose=True)
    ptxas = {}
    for src in ("lora_linear.cu", "flash_attention.cu", "flash_fwd.cu"):
        ptxas.update(cs.ptxas_report(src) or {})
    warnings = {src: sorted({line.strip() for line in log.splitlines()
                             if "arning" in line or "wgmma" in line})
                for src, log in _lib.BUILD_LOGS.items()}
    out = {"root": str(root), "edits": edits,
           "ptxas": {k: v for k, v in ptxas.items()
                     if k.startswith(("lora_", "attn_fwd", "splash_fwd"))},
           "warnings": {k: v for k, v in warnings.items() if v}}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    out["lora_check"] = lora_checks(torch, cs, lora, randn)
    out["lora_times"] = lora_times(torch, cs, lora, randn)
    torch.cuda.empty_cache()
    out["attention"] = attention_rows(torch, F, cs, attention, flash_fwd, splash, randn)
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
