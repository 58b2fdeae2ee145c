#!/usr/bin/env python3
"""K1's autograd pair on one CUDA card against the plain pair on the CPU, at
every head size of the model registry, with the elementwise backward bound
of tests/test_torch_kernels.py (`_close_bwd`) read as a ratio.

    python3 scripts/torch_flash_pair_check.py [--root DIR ...] [--draws 3]

For each checkout named by `--root` (this one by default; another, such as
the parent unpacked under `build/` by `git archive`, takes the same
wrappers), one child process builds the checkout's kernels and, for head
sizes 32, 64, 80, 96, 100, 128 and 256 and each draw (a
`torch.Generator` seeded with the draw, inputs as the test's autograd
case: B2 Hq8 G2 T130, bf16), prints one JSON line with, for dQ, dK and
dV, the worst ratio of error to bound and the query row where it falls:

  * `pair`: `causal_attention` with grad on the card (K1's forward and
    backward) against the same on CPU copies (the plain pair);
  * `kernel`: K1's backward against its plain version, both fed the
    card's O and L (the kernel alone);
  * `plain_o`: the plain backward fed the card's O and L against the
    plain backward fed the CPU's: what the two forwards' O alone moves.

A ratio above 1 fails the elementwise bound. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

HEAD_SIZES = (32, 64, 80, 96, 100, 128, 256)


def worst(got, want) -> dict:
    """The worst |got - want| over `_close_bwd`'s bound, and its query row."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound = (2.0 ** -10 + 2.0 ** -4 * float(want.pow(2).mean().sqrt())
             + 2.0 ** -6 * want.abs())
    ratio = diff / bound
    at = int(ratio.argmax())
    return {"worst": float(ratio.max()), "row": at // want.shape[-1] % want.shape[-2],
            "max_abs_err": float(diff.max()),
            "rel_l2_err": float((got - want).norm() / want.norm())}


def child(root: str, draws: int) -> int:
    sys.path.insert(0, root)
    import torch

    from dualhyp_tpu_torch.ops import _lib, attention

    if not torch.cuda.is_available():
        print("torch_flash_pair_check: no CUDA device is available", file=sys.stderr)
        return 2
    _lib.build()
    for d in HEAD_SIZES:
        scale = d ** -0.5
        for draw in range(draws):
            gen = torch.Generator(device="cuda").manual_seed(draw)

            def randn(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

            q, do = randn(2, 8, 130, d), randn(2, 8, 130, d)
            k, v = randn(2, 2, 130, d), randn(2, 2, 130, d)
            grads = {}
            for where in ("cuda", "cpu"):
                leaves = [x.to(where).detach().requires_grad_() for x in (q, k, v)]
                attention.causal_attention(*leaves).backward(do.to(where))
                grads[where] = [x.grad.cpu() for x in leaves]
            o, lse = attention._flash_fwd(q, k, v, scale)
            kernel = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
            plain = attention.flash_attention_bwd_plain(
                *(x.cpu() for x in (q, k, v, o, lse, do)), scale)
            line = {"root": root, "head_size": d, "draw": draw}
            for i, name in enumerate(("dq", "dk", "dv")):
                line[name] = {"pair": worst(grads["cuda"][i], grads["cpu"][i]),
                              "kernel": worst(kernel[i].cpu(), plain[i]),
                              "plain_o": worst(plain[i], grads["cpu"][i])}
            print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None,
                        help="a checkout (repeatable; default: this one)")
    parser.add_argument("--draws", type=int, default=3)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child is not None:
        return child(args.child, args.draws)
    rc = 0
    for root in args.root or ["."]:
        rc |= subprocess.run([sys.executable, __file__, "--child", root,
                              "--draws", str(args.draws)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
