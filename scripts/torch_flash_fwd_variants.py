#!/usr/bin/env python3
"""K1's forward at head sizes 80 and 96 (phi-2, Phi-3) and K1's backward at
100 (open_llama_3b) of the PyTorch port on one CUDA card, in variants of
csrc/flash_attention.cu and csrc/flash_attention_bwd.cu, or in other
checkouts.

    python3 scripts/torch_flash_fwd_variants.py [--edits JSON ...] [--root DIR ...]
        [--guards]

One JSON line a variant: this checkout's sources, each `--edits` (a JSON
list of "OLD=>NEW", OLD occurring once in one of the two sources; the copy
is built apart from the checkout's library) and each `--root` (another
checkout, e.g. the parent unpacked by `git archive` under build/; repeat
roots for turns: --root build/parent --root . --root . --root build/parent
with no default variant when a root is given). Every variant runs in a
child process of its own, with this script's measuring code: the registers
and spills of every instance of `flash_fwd_kernel`, `splash_fwd` and
`flash_bwd_kernel` (`-Xptxas -v`, and whether ptxas serialized any wgmma);
then, at B8 Hq32 G32 (the models' own heads and groups), K1's forward at
T1024 and T384 (chip_smoke.compare against the plain version, device ms:
one call after an L2 flush) and K1's backward at T1024 D100, on contiguous
inputs and on the model's layout (q and k contiguous as K3 writes them, v a
view of the fused QKV, dO the transposed view autograd hands back), against
the plain version (compare_scaled), with its device ms and the peak memory
a call allocates; SDPA's forward and backward beside them. `--guards` also
times the other instances of the same sources (K1's forward at D32, D64,
D100 through its padded copy, D128 at T1024 and T384, D256, L1's forward
at D64, D80 and D128, K6 / K7 at bf16) so a variant can be held to the
parent's. The card's name and power limit come first; only
numbers inside one call compare. Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")


def edited_sources(edits: list[str], tag: str) -> Path:
    dst = ROOT / "build" / "flash_fwd_variants" / tag / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "dualhyp_tpu_torch" / "csrc", dst)
    texts = {name: (dst / name).read_text() for name in SOURCES}
    for edit in edits:
        old, new = edit.split("=>")
        hits = [name for name, src in texts.items() if src.count(old) == 1]
        if len(hits) != 1 or any(texts[n].count(old) > 1 for n in SOURCES):
            raise SystemExit(f"edit {old!r} does not occur once in one of {SOURCES}")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for name, src in texts.items():
        (dst / name).write_text(src)
    return dst


def fused_layout(torch, gen, b, nh, t, hs):
    """q, k, v, dO as the model hands them to K1 (MHA: G = Hq): q and k
    contiguous (K3's outputs), v a view of the fused QKV projection's
    (B, T, 3 Hq D) output, dO the (B, Hq, T, D) view of a (B, T, Hq D)
    gradient."""
    qkv = torch.randn((b, t, nh, 3, hs), generator=gen, device="cuda").to(torch.bfloat16)
    q = qkv[:, :, :, 0].transpose(1, 2).contiguous()
    k = qkv[:, :, :, 1].transpose(1, 2).contiguous()
    v = qkv[:, :, :, 2].transpose(1, 2)
    do = torch.randn((b, t, nh * hs), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, do.view(b, t, nh, hs).transpose(1, 2)


def child(root: Path, csrc: str | None, seed: int, guards: bool) -> None:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from dualhyp_tpu_torch.ops import _lib, attention

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)  # this checkout's measuring code
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    if csrc:
        _lib.CSRC = Path(csrc)
        _lib.BUILD_ROOT = Path(csrc).parent / "lib"
    _lib.build(verbose=True)
    keep = ("flash_fwd_kernel", "splash_fwd", "flash_bwd_kernel")
    out = {"ptxas": {k: v for src in SOURCES for k, v in (cs.ptxas_report(src) or {}).items()
                     if k.startswith(keep)},
           "serialized_wgmma": [line.strip()[:160] for src in SOURCES
                                for line in _lib.BUILD_LOGS.get(src, "").splitlines()
                                if "C7512" in line or "serializ" in line]}
    cs.warm_up(torch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, nh = 8, 32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    for hs in (80, 96):
        scale = 1.0 / math.sqrt(hs)
        for t in (1024, 384):
            q, k, v = randn(b, nh, t, hs), randn(b, nh, t, hs), randn(b, nh, t, hs)
            fn = lambda: attention._flash_fwd(q, k, v, scale)  # noqa: E731
            o, lse = fn()
            o_plain, lse_plain = attention.causal_attention_plain_lse(q, k, v, scale)
            out[f"fwd_d{hs}_t{t}"] = {
                "max_abs_err": cs.compare("flash_attention_fwd", o, o_plain, torch),
                "lse_max_abs_err": float((lse - lse_plain).abs().max()),
                "device_ms": cs.device_ms(fn, torch, iters=5),
                "sdpa_ms": cs.time_ms(lambda: cs.sdpa_gqa(F, q, k, v, scale), torch, iters=5)}
            del q, k, v, o, lse, o_plain, lse_plain

    hs, t = 100, 1024
    scale = 1.0 / math.sqrt(hs)
    layouts = {"contiguous": tuple(randn(b, nh, t, hs) for _ in range(4)),
               "fused_qkv": fused_layout(torch, gen, b, nh, t, hs)}
    for name, (q, k, v, do) in layouts.items():
        o, lse = attention._flash_fwd(q, k, v, scale)
        fn = lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, scale)  # noqa: E731
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
        row = {}
        for part, x, y in zip("qkv", got, want):
            try:
                row[f"d{part}"] = cs.compare_scaled(f"flash_attention_bwd d{part}", x, y, torch)
            except RuntimeError as err:
                row[f"d{part}"] = {"error": str(err)[-300:]}
        del got, want
        row.update(peak_mb=peak / 2**20, device_ms=cs.device_ms(fn, torch, iters=5))
        if name == "contiguous":
            qr, kr, vr = (z.detach().requires_grad_() for z in (q, k, v))
            sdpa_out = cs.sdpa_gqa(F, qr, kr, vr, scale)
            row["sdpa_bwd_ms"] = cs.time_ms(
                lambda: torch.autograd.grad(sdpa_out, (qr, kr, vr), do, retain_graph=True),
                torch, iters=5)
            del qr, kr, vr, sdpa_out
        out[f"bwd_d100_{name}"] = row
        del o, lse
    del layouts
    torch.cuda.empty_cache()

    if guards:
        from dualhyp_tpu_torch.ops import flash_fwd, splash

        for hs, hq, g, t in ((32, 4, 4, 1024), (64, 32, 4, 1024), (100, 32, 32, 1024),
                             (128, 32, 8, 1024), (128, 32, 8, 384), (256, 8, 1, 1024)):
            q, k, v = randn(b, hq, t, hs), randn(b, g, t, hs), randn(b, g, t, hs)
            s = 1.0 / math.sqrt(hs)
            out[f"guard_fwd_d{hs}" + ("" if t == 1024 else f"_t{t}")] = cs.device_ms(
                lambda: attention._flash_fwd(q, k, v, s), torch, iters=5)
        t = 1024
        for hs, g in ((64, 4), (80, 32), (128, 8)):
            q, k, v = randn(b, 32, t, hs), randn(b, g, t, hs), randn(b, g, t, hs)
            s = 1.0 / math.sqrt(hs)
            out[f"guard_splash_fwd_d{hs}"] = cs.device_ms(lambda: splash.splash_fwd(q, k, v, s),
                                                          torch, iters=5)
        q, k, v = randn(b, 32, t, 64), randn(b, 4, t, 64), randn(b, 4, t, 64)
        out["guard_k7_bf16"] = cs.device_ms(lambda: flash_fwd.causal_attention_fwd(q, k, v),
                                            torch, iters=5)
        q, k, v = randn(b, 20, 1500, 64), randn(b, 20, 1500, 64), randn(b, 20, 1500, 64)
        out["guard_k6_bf16"] = cs.device_ms(lambda: flash_fwd.full_attention_fwd(q, k, v),
                                            torch, iters=5)
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--edits", action="append", default=[])
    parser.add_argument("--root", action="append", default=[])
    parser.add_argument("--guards", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--csrc", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(Path(args.child), args.csrc, args.seed, args.guards)
        return 0
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    variants = [{"root": str(Path(r).resolve())} for r in args.root] or [{"root": str(ROOT)}]
    variants += [{"root": str(ROOT), "edits": json.loads(e)} for e in args.edits]
    for i, var in enumerate(variants):
        print(json.dumps({"variant": i, **var}), flush=True)
        cmd = [sys.executable, __file__, "--child", var["root"], "--seed", str(args.seed)]
        if args.guards:
            cmd.append("--guards")
        if var.get("edits"):
            cmd += ["--csrc", str(edited_sources(var["edits"], f"v{i}"))]
        rc = subprocess.run(cmd, env=dict(os.environ)).returncode
        if rc:
            print(json.dumps({"variant": i, "rc": rc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
