#!/usr/bin/env python3
"""Phases of `chip_smoke.py` from one or more checkouts, run in turns on one
CUDA card.

    python3 scripts/torch_phase_turns.py --phase gmm_bwd_phase --phase flash_fwd_phase \\
        [--root DIR[:FLAG,...] ...] [--phases-from DIR] [--seed 0]

For each `--root` in the order given (this checkout by default; repeat a
root to run it again, e.g. parent, change, change, parent with the parent
unpacked under `build/` by `git archive`), one child process imports that
checkout's `chip_smoke.py` and kernel library, builds the library with
`-Xptxas -v` (and the root's FLAGs after a colon, appended to nvcc's
flags: a variant that the sources select with a macro, such as
`.:-DX=1`), prints the registers and spills of its kernels (and, where
the checkout's `chip_smoke.py` counts them, their wgmma instructions) as
one JSON line, then runs each named phase (`fn(torch, seed)`; a phase
given as `name:key=value,...` takes those keyword arguments, read as
Python literals, e.g. `flash_bwd_phase:g=8,hs=128`), whose own JSON lines
(kernel checks, device ms, bounds) pass through. With
`--phases-from DIR` every turn takes its phases from DIR's `chip_smoke.py`
and its kernels and package from its root: one measuring code for a parent
that lacks a phase (its public ops must take the same arguments). Each turn
starts with a line {"turn": i, "root": ...} and ends with {"turn": i, "rc":
...}. The card's name and power limit come first. Only numbers inside one
call compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "flash_fwd.cu", "grouped_matmul.cu",
           "int4_matmul.cu", "lora_linear.cu", "swiglu.cu", "rmsnorm.cu", "rope.cu")


def child(root: Path, flags: list[str], phases: list[str], seed: int,
          phases_from: Path | None = None) -> int:
    sys.path.insert(0, str(root))
    import importlib.util

    import torch

    from dualhyp_tpu_torch.ops import _lib

    if phases_from is None:
        import chip_smoke as cs
    else:
        spec = importlib.util.spec_from_file_location("chip_smoke", phases_from / "chip_smoke.py")
        cs = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = cs
        spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("torch_phase_turns: no CUDA device is available", file=sys.stderr)
        return 2
    _lib.NVCC_FLAGS = (*_lib.NVCC_FLAGS, *flags)
    lib = _lib.build(verbose=True)
    cs.emit({"flags": flags, "ptxas": {src: cs.ptxas_report(src) for src in SOURCES},
             **({"HGMMA": cs.sass_counts(lib)} if hasattr(cs, "sass_counts") else {})})
    for phase in phases:
        name, _, args = phase.partition(":")
        kwargs = {k: ast.literal_eval(v) for k, v in
                  (item.split("=", 1) for item in args.split(",") if item)}
        getattr(cs, name)(torch, seed, **kwargs)
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None,
                        help="a checkout, with nvcc flags after a colon (repeatable, run in "
                             "the order given; default: this one)")
    parser.add_argument("--phase", action="append", required=True,
                        help="a chip_smoke.py phase function, e.g. gmm_bwd_phase (repeatable)")
    parser.add_argument("--phases-from", type=Path, default=None,
                        help="a checkout whose chip_smoke.py gives every turn its phases")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    turns = [(Path(r.partition(":")[0]).resolve(), [f for f in r.partition(":")[2].split(",") if f])
             for r in (args.root or [str(Path(__file__).resolve().parents[1])])]
    phases_from = args.phases_from.resolve() if args.phases_from else None
    if args.child:
        return child(*turns[0], args.phase, args.seed, phases_from)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    rc = 0
    for turn, (root, flags) in enumerate(turns):
        print(json.dumps({"turn": turn, "root": str(root), "flags": flags}), flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             f"--root={root}:{','.join(flags)}", "--seed", str(args.seed),
             *(f"--phase={p}" for p in args.phase),
             *([f"--phases-from={phases_from}"] if phases_from else [])],
            cwd=root, stdout=sys.stdout, stderr=subprocess.PIPE, text=True)
        rc = rc or proc.returncode
        print(json.dumps({"turn": turn, "rc": proc.returncode,
                          **({"stderr": proc.stderr[-3000:]} if proc.returncode else {})}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
