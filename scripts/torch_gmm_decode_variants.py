#!/usr/bin/env python3
"""L2's forward at decode rows of the PyTorch port, timed on one CUDA card at
each cluster size, in variants of the sources or in another checkout.

    python3 scripts/torch_gmm_decode_variants.py [--variant JSON ...] [--root DIR ...]

The crossover against the TMA kernel: `--variant '{}'` (the decode kernel up
to 32 rows, its most) beside `--variant '{"edits": ["constexpr int
kDecodeRows = 32;=>constexpr int kDecodeRows = 0;"]}'` (the TMA kernel at
every row count).

For each `--variant` of this checkout (its sources by default; a JSON
object {"flags": [...], "edits": ["OLD=>NEW", ...]}: nvcc flags appended to
the port's and text edits of a copy of the sources, OLD occurring once) and
each `--root` (another checkout, such as the parent unpacked under `build/`
by `git archive`, with its own sources), one child process builds the kernel
library apart from the checkout's own and prints one JSON line: the
registers and spills of grouped_matmul.cu's kernels (`-Xptxas -v`); the
device ms of a one-element add (the harness's floor); then, at Mixtral's
decode shapes (fc_1 N 14336 K 4096, proj N 4096 K 14336) with 4, 6 and 8
of the 8 experts busy at 16 rows, and with all 8 busy at 32, 64 and 65
rows: the output of `gmm.grouped_matmul` against its plain version under
chip_smoke.TOLERANCES, its device ms (one call after an L2 flush, 20 calls)
and `torch._grouped_mm`'s, and, where the checkout has
`gmm.decode_plan`, the decode kernel's device ms at every cluster of 1, 2,
4 and 8 CTAs beside the plan's choice. Before the timings a sweep of small
shapes (rows 1 to 64, ragged N and K, empty, single and skewed groups, rows
past the last group, every cluster size) is held to the plain version; its
failures are listed. The card's name and power limit come first. Only
numbers inside one call compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_EXPERT = 8
# Mixtral-8x7B's expert linears: (name, N, K); fc_2 has fc_1's shape
SHAPES = (("fc_1", 14336, 4096), ("proj", 4096, 14336))
# the busy experts, in the order they take rows
ORDER = (0, 3, 5, 1, 6, 2, 7, 4)
# (rows, busy experts) timed at each shape
TIMED = ((16, 4), (16, 6), (16, 8), (32, 8), (64, 8), (65, 8))


def group_sizes(rows: int, busy: int, past: int = 0) -> list[int]:
    """`rows - past` rows over the first `busy` experts of ORDER, as evenly
    as they go (the first ones one more); `past` rows after the last group."""
    held = rows - past
    sizes = [0] * N_EXPERT
    for i, e in enumerate(ORDER[:busy]):
        sizes[e] = held // busy + (i < held % busy)
    return sizes


def sweep(torch, cs, gmm, randn, has_plan: bool) -> dict:
    """The small shapes' checks: the failures, and how many ran."""
    dev = torch.device("cuda")
    failures, runs = [], 0
    for rows in (1, 7, 8, 9, 16, 17, 33, 64):
        for n, k in ((200, 264), (128, 40), (256, 2048)):
            w = randn(N_EXPERT, n, k, std=0.05)
            lhs = randn(rows, k)
            cases = {"all": group_sizes(rows, min(rows, N_EXPERT)),
                     "one": group_sizes(rows, 1), "skew": [rows - rows // 3, 0, rows // 3] + [0] * 5,
                     "past": group_sizes(rows, 3, past=rows // 2)}
            for case, sizes in cases.items():
                s = torch.tensor(sizes, dtype=torch.int32, device=dev)
                want = gmm.grouped_matmul_plain(lhs, w, s)
                clusters = (1, 2, 4, 8) if has_plan else (None,)
                for cluster in clusters:
                    if cluster is None:
                        got = gmm.grouped_matmul(lhs, w, s)
                    else:
                        got = torch.full_like(want, float("nan"))
                        gmm.GROUPED_MATMUL(dev, lhs.data_ptr(), w.data_ptr(), s.data_ptr(),
                                           got.data_ptr(), rows, n, k, N_EXPERT, cluster)
                    runs += 1
                    try:
                        cs.compare("grouped_matmul", got, want, torch)
                    except RuntimeError as err:
                        failures.append(f"rows {rows} n {n} k {k} {case} cluster {cluster}: {err}")
    return {"runs": runs, "failures": failures[:20], "n_failures": len(failures)}


def times(torch, cs, gmm, randn, has_plan: bool) -> dict:
    dev = torch.device("cuda")
    out = {}
    for name, n, k in SHAPES:
        w = randn(N_EXPERT, n, k, std=0.02)
        for rows, busy in TIMED:
            sizes = torch.tensor(group_sizes(rows, busy), dtype=torch.int32, device=dev)
            lhs = randn(rows, k)
            want = gmm.grouped_matmul_plain(lhs, w, sizes)
            fn = lambda: gmm.grouped_matmul(lhs, w, sizes)  # noqa: E731
            row = {"group_sizes": sizes.tolist(),
                   "bound_ms": cs.bound(rows * k * 2 + busy * n * k * 2 + rows * n * 2,
                                        2 * rows * n * k, cs.BF16_TENSOR_FLOPS)[0],
                   "max_abs_err": cs.compare("grouped_matmul", fn(), want, torch),
                   "device_ms": cs.device_ms(fn, torch)}
            lib, lib_name = cs.grouped_mm_library(torch, lhs, w, sizes)
            row.update(library=lib_name, library_device_ms=cs.device_ms(lib, torch))
            if has_plan and rows <= gmm.DECODE_ROWS:
                row["plan"] = gmm.decode_plan(rows, n, k, N_EXPERT)["cluster"]
                got = torch.empty_like(want)
                for cluster in (1, 2, 4, 8):
                    def direct(cluster=cluster):
                        gmm.GROUPED_MATMUL(dev, lhs.data_ptr(), w.data_ptr(), sizes.data_ptr(),
                                           got.data_ptr(), rows, n, k, N_EXPERT, cluster)

                    direct()
                    row[f"err_{cluster}"] = cs.compare("grouped_matmul", got, want, torch)
                    row[f"device_ms_{cluster}"] = cs.device_ms(direct, torch)
            out[f"{name}_{rows}_{busy}"] = row
        del w
        torch.cuda.empty_cache()
    return out


def child(root: Path, variant: dict) -> dict:
    # this checkout's measuring code, the root's package and kernels
    sys.path.insert(0, str(ROOT / "scripts"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from torch_lora_attn_variants import edited_sources

    sys.path.insert(0, str(root))
    from dualhyp_tpu_torch.ops import _lib, gmm

    _lib.NVCC_FLAGS = (*_lib.NVCC_FLAGS, *variant.get("flags", []))
    _lib.BUILD_ROOT = ROOT / "build" / "gmm_decode_variants"
    _lib.CSRC = edited_sources(_lib.CSRC, _lib.BUILD_ROOT / "src", variant.get("edits", []))
    _lib.build(verbose=True)
    ptxas = cs.ptxas_report("grouped_matmul.cu") or {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    has_plan = hasattr(gmm, "decode_plan")
    cs.warm_up(torch)
    one = torch.zeros(1, device=dev)
    return {"root": str(root), "variant": variant, "ptxas": ptxas,
            "floor_ms": cs.device_ms(lambda: one.add_(1), torch),
            "sweep": sweep(torch, cs, gmm, randn, has_plan),
            "times": times(torch, cs, gmm, randn, has_plan)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=None,
                        help='{"flags": [...], "edits": ["OLD=>NEW", ...]} (repeatable)')
    parser.add_argument("--root", action="append", default=[],
                        help="another checkout, timed as it is (repeatable, after the variants)")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    runs = [(ROOT, json.loads(v)) for v in (args.variant or ([] if args.root else ["{}"]))]
    runs += [(Path(r).resolve(), {}) for r in args.root]
    if args.child:
        print(json.dumps(child(*runs[0])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    rc = 0
    for root, variant in runs:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               *([f"--variant={json.dumps(variant)}"] if root == ROOT
                                 else [f"--root={root}"])],
                              cwd=ROOT, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            rc = 1
            tail = [line for line in proc.stderr.splitlines() if "ptxas" not in line]
            print(json.dumps({"root": str(root), "variant": variant, "rc": proc.returncode,
                              "stderr": "\n".join(tail)[-3000:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
