#!/usr/bin/env python3
"""K5's and K4's middle rows (`csrc/mid_matmul.cuh`, a verify step's 33 to
144 rows) of the PyTorch port on one CUDA card: their plans against others,
the parent's designs and cuBLAS.

    python3 scripts/torch_verify_mid_variants.py [--k5-plan JSON ...]
        [--k4-plan JSON ...] [--rows N ...] [--probe [--edits JSON]] [--seed 0]

K5 at TinyLlama's fused QKV (rank 48, three blocks of 16) and proj (rank
16) and at the MLP's shapes under --lora_mlp (rank 16), K4 at TinyLlama's
MLP, each at 36, 72 and 144 rows (K4 at 72 and 144) and at each `--rows`
(above MID_ROWS the middle path is taken as if MID_ROWS were N: two token
tiles). Each call is held to its plain version under
chip_smoke.TOLERANCES; one JSON line a shape: the device ms (one call after
an L2 flush, 20 calls) of the plan the dispatch takes (`mid`), of each
`--k5-plan` / `--k4-plan` (a JSON object over it: K5 {"cluster": 2}; K4
{"gate": {"cluster": 2}}, {"down": {"cluster": 8}}, {"pdl": false}), of the
parent's design (the dispatch with MID_ROWS at
DECODE_ROWS: K5's rank + TMA kernels, K4's row tiles) and of cuBLAS (K5:
x W^T + s (x A^T) B^T, three products and an add; K4: three products), with
the bound (the bytes of every input read once and the output written
once, or the products at the bf16 tensor peak). The card's name and power
limit come first; only numbers inside one call compare. `--probe` builds a
copy of the sources under build/ whose kernel stamps the card's global timer
(ns) at its phases, and adds to each shape's line the median and the largest
microseconds a CTA of the dispatch's plan spent in each (K4: the gate and the
down launch): its barriers' set-up, waiting for the first step, the loop, the first
cluster barrier (the slowest CTA's loop), storing the parts into the owners'
shared memory, the second barrier, the sums and stores. `--edits` (a JSON
list of "OLD=>NEW", OLD occurring once in csrc/mid_matmul.cuh) edits that copy
too; its results are not held to the plain version (an edit may drop work to
time the rest). Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the probe's stamps in csrc/mid_matmul.cuh: (text, the stamp's index,
# stamped before the text rather than after it)
STAMPS = [
    ("mid_kernel(const Args p) {\n  using S = Shape<NT, kWg, Epi>;\n", 0, False),
    ("(ranks - 1) * p.r * S::kLd * 4);\n  }\n  __syncthreads();\n", 1, False),
    ("      mbar_wait(&full[slot], (i / S::kStages) & 1);\n", 2, False),
    ("  if constexpr (Epi::kParts == 2) griddep_launch_dependents();", 3, True),
    ("  cluster_wait();  // every CTA of the cluster is done with its ring\n", 4, False),
    ("  cluster_arrive();\n  cluster_wait();  // every column's parts have landed", 5, True),
    ("  cluster_wait();  // every column's parts have landed\n", 6, False),
    ("\n}\n\n// Launches mid_kernel", 7, True),
]
PHASES = ["setup", "first_wait", "loop", "barrier_1", "push", "barrier_2", "sums"]


def probe_sources(edits=()) -> Path:
    """A copy of csrc/ under build/ with the probe's stamps; each CTA's
    thread 0 writes them to a per-file table (the down launch's rows from
    4096), read by dh_mid_stamps."""
    import shutil

    dst = ROOT / "build" / "verify_mid_variants" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "dualhyp_tpu_torch" / "csrc", dst)
    path = dst / "mid_matmul.cuh"
    src = path.read_text().replace(
        "namespace mid {\n", "namespace mid {\nstatic __device__ long long g_stamp[8192][8];\n", 1)
    for edit in edits:
        old, new = edit.split("=>")
        if src.count(old) != 1:
            raise SystemExit(f"edit {old!r} does not occur once")
        src = src.replace(old, new)
    for text, i, before in STAMPS:
        if src.count(text) != 1:
            raise SystemExit(f"probe point {text!r} does not occur once")
        stamp = ("  __syncthreads();\n" if i == 7 else "\n" if i == 3 else "") + (
            f"  if (threadIdx.x == 0{' && i == 0' if i == 2 else ''}) asm volatile("
            f"\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_stamp[blockIdx.x + "
            f"(std::is_same<Epi, DownMid>::value ? 4096 : 0)][{i}]));\n")
        src = src.replace(text, stamp + text if before else text + stamp)
    path.write_text(src)
    for name in ("lora_linear.cu", "swiglu.cu"):
        cu = dst / name
        cu.write_text(cu.read_text() + (
            f"\nDH_EXPORT int dh_mid_stamps_{name.split('.')[0]}(void* out) {{\n"
            "  return (int)cudaMemcpyFromSymbol(out, mid::g_stamp, sizeof(mid::g_stamp));\n}\n"))
    return dst


def probe_us(torch, cs, lib, symbol, fn, ctas, base=0):
    """The median and largest microseconds a CTA spent in each phase of one
    cold call of `fn` (stamps of CTAs base + [0, ctas))."""
    import ctypes

    import numpy as np

    stamps = np.zeros((8192, 8), np.int64)
    cs.l2_flush(torch)()
    fn()
    torch.cuda.synchronize()
    getattr(lib, symbol)(stamps.ctypes.data_as(ctypes.c_void_p))
    t = stamps[base:base + ctas]
    t = (t - t[:, 0].min()) / 1e3
    d = np.diff(t, axis=1)
    return {"phases_us": {p: [float(np.median(d[:, j])), float(d[:, j].max())]
                          for j, p in enumerate(PHASES)},
            "end_us": float(t[:, 7].max())}


# (name, O, D, blocks of rank 16)
K5_SHAPES = [("qkv", 2560, 2048, 3), ("proj", 2048, 2048, 1), ("mlp_fc", 5632, 2048, 1),
             ("mlp_proj", 2048, 5632, 1)]
K5_ROWS = [36, 72, 144]
K4_ROWS = [72, 144]


def k5_rows(torch, cs, lora, mid, randn, rows_list, overrides, lib=None, check=True):
    for name, o, d, blocks in K5_SHAPES:
        r = 16 * blocks
        w = randn(o, d, std=0.02)
        a = randn(r, d, std=1 / math.sqrt(d))
        shapes = (d, (o - d) // 2, (o - d) // 2) if blocks == 3 else (o,)
        b = lora.lora_qkv_block_b(randn(o, 16, std=0.02), shapes, 16)
        for rows in rows_list:
            x = randn(rows, d)
            fn = lambda: lora.lora_linear(x, w, a, b, 1.0)  # noqa: E731
            want = lora.lora_linear_plain(x, w, a, b, 1.0)
            bms, by = cs.bound((rows * d + o * d + r * d + o * r + rows * o) * 2,
                               2 * rows * (o * d + r * d + o * 16), cs.BF16_TENSOR_FLOPS)
            row = {"kernel": "K5", "name": name, "shape": [rows, o, d, r],
                   "bound_ms": bms, "bound_by": by}
            saved_rows, saved_plan = lora.MID_ROWS, lora.mid_plan
            lora.MID_ROWS = max(saved_rows, rows)
            for i, over in enumerate([{}] + overrides):
                def plan(rows_, o_, d_, r_, s=1.0, separate=False, over=over):
                    return mid.plan(rows_, o_, d_, rank=s != 0, sep=s != 0 and separate,
                                    r=-(-r_ // 8) * 8 if s != 0 else 0,
                                    cluster=over.get("cluster"))
                lora.mid_plan = plan
                try:
                    p = plan(rows, o, d, r)
                    err = (cs.compare("lora_linear", cs.repeatable("lora_linear", fn, torch),
                                      want, torch) if check else None)
                    entry = {"plan": {k: p[k] for k in ("tiles", "tokens", "wg", "cluster",
                                                        "ctas", "smem", "stages")},
                             "max_abs_err": err, "device_ms": cs.device_ms(fn, torch)}
                    if lib is not None and i == 0:
                        entry["probe"] = probe_us(torch, cs, lib, "dh_mid_stamps_lora_linear",
                                                  fn, p["ctas"])
                except (RuntimeError, ValueError) as exc:
                    entry = {"over": over, "error": str(exc)}
                finally:
                    lora.mid_plan = saved_plan
                row["mid" if i == 0 else f"plan_{i}"] = entry
            lora.MID_ROWS = lora.DECODE_ROWS  # the parent's rank + TMA kernels
            row["parent_device_ms"] = cs.device_ms(fn, torch)
            lora.MID_ROWS = saved_rows
            library = lambda: x @ w.t() + 1.0 * ((x @ a.t()) @ b.t())  # noqa: E731
            row["cublas_device_ms"] = cs.device_ms(library, torch)
            row["share_of_bound"] = bms / row["mid"].get("device_ms", math.inf)
            print(json.dumps(row), flush=True)


def k4_rows(torch, cs, swiglu, mid, randn, rows_list, overrides, lib=None, check=True):
    d, inter = 2048, 5632
    w1, w2 = randn(inter, d, std=0.02), randn(inter, d, std=0.02)
    w3 = randn(d, inter, std=0.02)
    for rows in rows_list:
        x = randn(rows, d)
        fn = lambda: swiglu.swiglu_mlp(x, w1, w2, w3)  # noqa: E731
        want = swiglu.swiglu_mlp_plain(x, w1, w2, w3)
        bms, by = cs.bound((2 * rows * d + 3 * inter * d) * 2, 6 * rows * d * inter,
                           cs.BF16_TENSOR_FLOPS)
        row = {"kernel": "K4", "shape": [rows, d, inter], "bound_ms": bms, "bound_by": by}
        saved_rows, saved_plan = swiglu.MID_ROWS, swiglu.mid_plan
        swiglu.MID_ROWS = max(saved_rows, rows)
        for i, over in enumerate([{}] + overrides):
            def plan(rows_, d_, inter_, over=over):
                g, dn = over.get("gate", {}), over.get("down", {})
                gate = mid.plan(rows_, inter_, d_, parts=2, cluster=g.get("cluster"))
                down = mid.plan(rows_, d_, inter_, cluster=dn.get("cluster"))
                return dict(tokens=gate["tokens"], gate=gate, down=down,
                            pdl=over.get("pdl", rows_ > swiglu.MID_PDL_ROWS))
            swiglu.mid_plan = plan
            try:
                p = plan(rows, d, inter)
                err = (cs.compare("swiglu_mlp", cs.repeatable("swiglu_mlp", fn, torch), want,
                                  torch) if check else None)
                entry = {"plan": {"pdl": p["pdl"], **{
                    stage: {k: p[stage][k] for k in ("tokens", "wg", "cluster", "ctas", "smem",
                                                     "stages")} for stage in ("gate", "down")}},
                    "max_abs_err": err, "device_ms": cs.device_ms(fn, torch)}
                if lib is not None and i == 0:
                    entry["probe_gate"] = probe_us(torch, cs, lib, "dh_mid_stamps_swiglu", fn,
                                                   p["gate"]["ctas"])
                    entry["probe_down"] = probe_us(torch, cs, lib, "dh_mid_stamps_swiglu", fn,
                                                   p["down"]["ctas"], 4096)
            except (RuntimeError, ValueError) as exc:
                entry = {"over": over, "error": str(exc)}
            finally:
                swiglu.mid_plan = saved_plan
            row["mid" if i == 0 else f"plan_{i}"] = entry
        swiglu.MID_ROWS = swiglu.DECODE_ROWS  # the parent's row tiles
        row["parent_device_ms"] = cs.device_ms(fn, torch)
        swiglu.MID_ROWS = saved_rows
        library = lambda: (torch.nn.functional.silu(x @ w1.t()) * (x @ w2.t())) @ w3.t()  # noqa: E731
        row["cublas_device_ms"] = cs.device_ms(library, torch)
        row["share_of_bound"] = bms / row["mid"].get("device_ms", math.inf)
        print(json.dumps(row), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--k5-plan", action="append", default=[])
    parser.add_argument("--k4-plan", action="append", default=[])
    parser.add_argument("--rows", type=int, action="append", default=[])
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--edits", default="[]")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from dualhyp_tpu_torch.ops import _lib, lora, mid, swiglu

    if not torch.cuda.is_available():
        print("torch_verify_mid_variants: no CUDA device is available", file=sys.stderr)
        return 2
    lib = None
    if args.probe:
        import ctypes

        _lib.CSRC = probe_sources(json.loads(args.edits))
        _lib.BUILD_ROOT = _lib.CSRC.parent / "lib"
        lib = ctypes.CDLL(str(_lib.build()))
        lib.dh_mid_stamps_lora_linear.argtypes = lib.dh_mid_stamps_swiglu.argtypes = [
            ctypes.c_void_p]
    _lib.build()
    cs.warm_up(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    k5_rows(torch, cs, lora, mid, randn, K5_ROWS + args.rows,
            [json.loads(p) for p in args.k5_plan], lib, check=args.edits == "[]")
    k4_rows(torch, cs, swiglu, mid, randn, K4_ROWS + args.rows,
            [json.loads(p) for p in args.k4_plan], lib, check=args.edits == "[]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
