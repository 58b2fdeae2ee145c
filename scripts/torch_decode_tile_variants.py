#!/usr/bin/env python3
"""K8's and K5's decode kernels (at most 16 rows) of the PyTorch port, timed
on one CUDA card at each cluster size, in variants of the sources.

    python3 scripts/torch_decode_tile_variants.py [--variant JSON ...]

For each `--variant` (this checkout's sources by default; a JSON object
{"flags": [...], "edits": ["OLD=>NEW", ...]}: nvcc flags appended to the
port's, such as "-DX=1" for a macro the sources read, and text edits of a copy of the
sources, OLD occurring once), one child process builds the kernel library
apart from the checkout's own, then prints one JSON line: the
registers and spills of the decode kernels (`-Xptxas -v`); then, for K8 at
TinyLlama-1.1B's int4 shapes (qkv, attn.proj, fc_1, mlp.proj, lm_head) and
K5 at its fused QKV (rank 48) and proj (rank 16), xin shared and separate,
at 1, 8 and 16 rows, for each cluster of 1, 2, 4 and 8 CTAs the kernel may
take: the output against the plain version under chip_smoke.TOLERANCES,
its device ms (one call after an L2 flush, 20 calls) and the launch plan's
choice; and the device ms of a one-element add (the harness's floor). The
card's name and power limit come first. Only numbers inside one call
compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = [1, 8, 16]


def check(cs, name, fn, got, want, torch):
    """Runs `fn` (writing `got`); the largest error under
    chip_smoke.compare, or the message where the launch fails or the kernel
    disagrees (then it is not timed)."""
    try:
        fn()
        return cs.compare(name, got, want, torch)
    except RuntimeError as err:
        return str(err)


def q4_times(torch, cs, int4, quant, randn) -> dict:
    out = {}
    dev = torch.device("cuda")
    for name, n, k in cs.Q4_SHAPES:
        packed, scales = quant.quantize_weight_int4(randn(n, k, std=0.02).float())
        for rows in ROWS:
            x = randn(rows, k)
            want = int4.q4_matmul_plain(x, packed, scales)
            got = torch.empty_like(want)
            row = {"plan": int4.decode_plan(rows, n, k)["cluster"]}
            for cluster in (1, 2, 4, 8):
                if cluster > k // 128:
                    continue

                def fn():
                    int4.Q4_MATMUL(dev, x.data_ptr(), x.stride(0), packed.data_ptr(),
                                   scales.data_ptr(), got.data_ptr(), got.data_ptr(), rows, n,
                                   k, int4.PATHS.index("decode"), cluster, 0)

                row[f"err_{cluster}"] = check(cs, "q4_matmul", fn, got, want, torch)
                if not isinstance(row[f"err_{cluster}"], str):
                    row[f"device_ms_{cluster}"] = cs.device_ms(fn, torch)
            out[f"{name}_{rows}"] = row
    return out


def lora_times(torch, cs, lora, randn) -> dict:
    out = {}
    dev = torch.device("cuda")
    r = cs.LORA_RANK
    for name, o, d, blocks in cs.LORA_SHAPES:
        w = randn(o, d, std=0.02)
        a = randn(blocks * r, d, std=1 / math.sqrt(d))
        b = randn(o, blocks * r, std=0.02)
        for rows in ROWS:
            for sep in (False, True):
                x = randn(rows, d)
                xin = randn(rows, d) if sep else x
                want = lora.lora_linear_plain(x, w, a, b, 1.0, xin)
                got = torch.empty_like(want)
                row = {"plan": lora.decode_plan(rows, o, d, blocks * r, 1.0, sep)["cluster"]}
                for cluster in (1, 2, 4, 8):

                    def fn():
                        lora.LORA_LINEAR(dev, x.data_ptr(), xin.data_ptr(), w.data_ptr(),
                                         a.data_ptr(), b.data_ptr(), 0, got.data_ptr(), 1.0,
                                         rows, o, d, blocks * r, lora.PATHS.index("decode"),
                                         cluster, 0)

                    row[f"err_{cluster}"] = check(cs, "lora_linear", fn, got, want, torch)
                    if not isinstance(row[f"err_{cluster}"], str):
                        row[f"device_ms_{cluster}"] = cs.device_ms(fn, torch)
                out[f"{name}_{rows}{'_xin' if sep else ''}"] = row
    return out


def child(variant: dict) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch

    import chip_smoke as cs
    from dualhyp_tpu_torch.ops import _lib, int4, lora, quant
    from torch_lora_attn_variants import edited_sources

    _lib.NVCC_FLAGS = (*_lib.NVCC_FLAGS, *variant.get("flags", []))
    _lib.BUILD_ROOT = _lib.BUILD_ROOT.parent / "decode_tile_variants"
    _lib.CSRC = edited_sources(_lib.CSRC, _lib.BUILD_ROOT / "src", variant.get("edits", []))
    _lib.build(verbose=True)
    ptxas = {}
    for src in ("int4_matmul.cu", "lora_linear.cu"):
        ptxas.update({k: v for k, v in (cs.ptxas_report(src) or {}).items() if "decode" in k})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    cs.warm_up(torch)
    one = torch.zeros(1, device=dev)
    return {"variant": variant, "ptxas": ptxas, "floor_ms": cs.device_ms(lambda: one.add_(1), torch),
            "q4_matmul": q4_times(torch, cs, int4, quant, randn),
            "lora_linear": lora_times(torch, cs, lora, randn)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=None,
                        help='{"flags": [...], "edits": ["OLD=>NEW", ...]} (repeatable)')
    parser.add_argument("--rows", type=int, nargs="+", default=ROWS,
                        help="row counts to time (default 1 8 16)")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    variants = [json.loads(v) for v in (args.variant or ["{}"])]
    ROWS[:] = args.rows
    if args.child:
        print(json.dumps(child(variants[0])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    rc = 0
    for variant in variants:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               f"--variant={json.dumps(variant)}", "--rows", *map(str, ROWS)],
                              cwd=ROOT,
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            rc = 1
            tail = [line for line in proc.stderr.splitlines() if "ptxas" not in line]
            print(json.dumps({"variant": variant, "rc": proc.returncode,
                              "stderr": "\n".join(tail)[-3000:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
