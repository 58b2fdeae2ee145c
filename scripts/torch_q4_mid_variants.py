#!/usr/bin/env python3
"""K8's middle kernel (`q4_mid_kernel`, 17 to MID_ROWS rows) of the PyTorch
port on one CUDA card: its plans against others, and where its time goes.

    python3 scripts/torch_q4_mid_variants.py [--plan JSON ...] [--edits JSON ...]
                                             [--probe]

At the verify step's and the Whisper beam's shapes (TinyLlama's qkv and fc_1
at 36, 72 and 144 rows; Whisper-large-v3's 1280 x 1280, fc1 and fc2 at 400),
each against the plain version under chip_smoke.TOLERANCES, one JSON line a
shape: the device ms (one call after an L2 flush, 20 calls) of the plan
`int4.mid_plan` takes, of each `--plan` (a JSON object over it, e.g.
{"cluster": 2} or {"tiles": 2, "tokens": 200}), of the wgmma/TMA tile the
dispatch takes above MID_ROWS, and of cuBLAS on the dequantised weight.
`--rows N` adds each shape at N rows (above MID_ROWS too: the plan is
then taken as if MID_ROWS were N). `--edits` (a JSON list of "OLD=>NEW",
OLD occurring once in
csrc/int4_matmul.cu) builds a copy of the sources so edited, apart from the
checkout's library, in its own child process. `--probe` stamps the
card's global timer (ns) at the kernel's phases in such a copy and prints,
for each shape, the median and the largest microseconds a CTA spent in
each: issuing the first loads, waiting for them, the groups, the ring's
drain, staging the parts, their exchange in the cluster (a barrier, then
bulk copies between the CTAs' shared memory), the sums. The
card's name and power limit come first; only numbers inside one call
compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [("qkv", 2560, 2048, 36), ("qkv", 2560, 2048, 72), ("qkv", 2560, 2048, 144),
          ("fc_1", 5632, 2048, 144), ("lm_head", 32000, 2048, 144),
          ("whisper_attn", 1280, 1280, 400), ("whisper_fc1", 5120, 1280, 400),
          ("whisper_fc2", 1280, 5120, 400)]
# the phases the probe stamps: (text, the stamp's index, stamped before the
# text rather than after it)
STAMPS = [
    ("  using L = MidLayout<NT>;\n", 0, False),
    ("#pragma unroll\n  for (int i = 0; i < kMidStages - 1; ++i) {\n    if (i < ng) load(i, g0 + i);\n"
     "    cp_async_commit();\n  }\n", 1, False),
    ("    cp_async_commit();\n    const unsigned char* st = smem + (i % kMidStages) * L::kStage;\n",
     2, False),
    ("    for (int e = 0; e < NT / 2; ++e) acc[e] += part[e] * ((e & 2) ? sc_hi : sc_lo);\n  }\n",
     3, False),
    ("  __syncthreads();  // the ring is done with: it holds the parts from here\n", 4, False),
    ("  const uint32_t share = cols * L::kTokLd * 4;  // bytes of one rank's columns\n", 5, True),
    ("  if (ranks > 1) mbar_wait(recv_bar, 0);  // every rank's parts of this CTA's columns are "
     "here\n", 6, False),
    ("  cluster_arrive();\n  cluster_wait();  // no CTA leaves while its parts may still be read\n",
     7, True),
]
PHASES = ["issue", "first_wait", "groups", "drain", "stage", "exchange", "sums"]


def edited_sources(edits: list[str], probe: bool, tag: str) -> Path:
    """A copy of csrc/ under build/ with the edits (and the probe's stamps)."""
    dst = ROOT / "build" / "q4_mid_variants" / tag / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "dualhyp_tpu_torch" / "csrc", dst)
    path = dst / "int4_matmul.cu"
    src = path.read_text()
    for edit in edits:
        old, new = edit.split("=>")
        if src.count(old) != 1:
            raise SystemExit(f"edit {old!r} does not occur once")
        src = src.replace(old, new)
    if probe:
        src = src.replace("namespace {\n", "__device__ long long g_stamp[4096][8];\n"
                          "namespace {\n", 1)
        for text, i, before in STAMPS:
            if src.count(text) != 1:
                raise SystemExit(f"probe point {text!r} does not occur once")
            stamp = ("  __syncthreads();\n" if i == 7 else "") + (
                f"  if (threadIdx.x == 0{' && i == 0' if i == 2 else ''}) asm volatile("
                f"\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_stamp[blockIdx.x][{i}]));\n")
            src = src.replace(text, stamp + text if before else text + stamp)
        src += ("\nDH_EXPORT int dh_q4_mid_stamps(void* out) {\n"
                "  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));\n}\n")
    path.write_text(src)
    return dst


def child(args) -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from dualhyp_tpu_torch.ops import _lib, int4, quant

    if args.csrc:
        _lib.CSRC = Path(args.csrc)
        _lib.BUILD_ROOT = Path(args.csrc).parent / "lib"
    lib = ctypes.CDLL(str(_lib.build()))
    cs.warm_up(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stamps = np.zeros((4096, 8), np.int64)
    base_plan, base_path = int4.mid_plan, int4.path_of
    mid_rows = int4.MID_ROWS
    shapes = SHAPES + [(name, n, k, rows) for rows in args.rows
                       for name, n, k in dict.fromkeys((s[:3] for s in SHAPES))]
    for name, n, k, rows in shapes:
        int4.MID_ROWS = max(mid_rows, rows)
        packed, scales = quant.quantize_weight_int4(
            (torch.randn(n, k, generator=gen, device=dev) * 0.02))
        x = torch.randn(rows, k, generator=gen, device=dev).to(torch.bfloat16)
        w_deq = quant.dequantize_weight_int4(packed, scales, torch.bfloat16)
        want = int4.q4_matmul_plain(x, packed, scales)
        fn = lambda: int4.q4_matmul(x, packed, scales)  # noqa: E731
        row = {"name": name, "shape": [rows, n, k],
               "path": base_path(rows, n, k) if rows <= mid_rows else "wgmma"}
        plans = [None] + [json.loads(p) for p in args.plan]
        for i, over in enumerate(plans):
            plan = dict(base_plan(rows, n, k), **(over or {}))
            int4.mid_plan = lambda *a, p=plan: p  # noqa: E731
            int4.path_of = lambda r, n_, k_: "mid"  # noqa: E731
            try:
                err = cs.compare("q4_matmul", fn(), want, torch)
                entry = {"plan": {key: plan[key] for key in ("tiles", "tokens", "cluster")},
                         "max_abs_err": err, "device_ms": cs.device_ms(fn, torch)}
                if args.probe and i == 0:
                    cs.l2_flush(torch)()
                    fn()
                    torch.cuda.synchronize()
                    lib.dh_q4_mid_stamps(stamps.ctypes.data_as(ctypes.c_void_p))
                    t = (stamps[:plan["ctas"]] - stamps[:plan["ctas"], 0].min()) / 1e3
                    d = np.diff(t, axis=1)
                    entry["probe_us"] = {p: [float(np.median(d[:, j])), float(d[:, j].max())]
                                         for j, p in enumerate(PHASES)}
                    entry["probe_end_us"] = float(t[:, 7].max())
            except RuntimeError as err:
                entry = {"plan": over, "error": str(err)}
            finally:
                int4.mid_plan, int4.path_of = base_plan, base_path
            row["mid" if i == 0 else f"plan_{i}"] = entry
        int4.MID_ROWS = int4.DECODE_ROWS
        row["wgmma_device_ms"] = cs.device_ms(fn, torch)
        int4.MID_ROWS = mid_rows
        row["cublas_device_ms"] = cs.device_ms(lambda: x @ w_deq.t(), torch)
        print(json.dumps(row), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--plan", action="append", default=[])
    parser.add_argument("--edits", action="append", default=[])
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--rows", type=int, action="append", default=[])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--csrc", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args)
        return 0
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    variants = [[]] + [json.loads(e) for e in args.edits]
    for i, edits in enumerate(variants):
        cmd = [sys.executable, __file__, "--child", "--seed", str(args.seed)]
        cmd += [a for p in args.plan for a in ("--plan", p)]
        cmd += [a for r in args.rows for a in ("--rows", str(r))]
        if edits or args.probe:
            cmd += ["--csrc", str(edited_sources(edits, args.probe, f"v{i}"))]
            cmd += ["--probe"] if args.probe else []
        print(json.dumps({"variant": i, "edits": edits}), flush=True)
        rc = subprocess.run(cmd, env=dict(os.environ)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
