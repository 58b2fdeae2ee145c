"""The gradients of the port's autograd ops against the JAX package's
custom VJPs, on the same numpy inputs, on the CPU.

On CPU tensors every op runs its plain version: K1's backward is
`flash_attention_bwd_plain`, compared here with `jax.vjp` of
`flash_vjp.flash_attention`, whose Pallas backward runs in interpret mode
at T=128 and falls back to XLA's gradients at T=96. K2's and K4's backwards
are plain formulas in both packages, K3's is the inverse rotation. Then
`torch.autograd.gradcheck` in float64 holds each op's backward against its
own forward.

Tolerances: fp32 atol 1e-5 on every gradient (the same arithmetic, sums in
another order), plus rtol 1e-5 on the SwiGLU gradients, whose weight
gradients reach ~10 (the tanh-gelu derivative is written out here and
taken by `jax.grad` there); the cross-entropy gradients at atol 1e-6 and
rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ops import cross_entropy as jce
from dualhyp_tpu.ops.pallas import flash_vjp, rmsnorm_kernel, rope_kernel, swiglu_kernel
from dualhyp_tpu_torch.ops import attention, cross_entropy, rmsnorm, rope, swiglu

ATOL = 1e-5


def _t(a, requires_grad=False):
    return torch.from_numpy(np.asarray(a, np.float32)).requires_grad_(requires_grad)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _qkv(rng, t, hq=4, g=2, b=1):
    return (rng.normal(size=(b, hq, t, 64)).astype(np.float32),
            rng.normal(size=(b, g, t, 64)).astype(np.float32),
            rng.normal(size=(b, g, t, 64)).astype(np.float32),
            rng.normal(size=(b, hq, t, 64)).astype(np.float32))


@pytest.mark.parametrize("t", [128, 96])
def test_flash_backward_plain_matches_jax_vjp(rng, t):
    """T=128: the Pallas `_bwd_kernel` in interpret mode; T=96: XLA's grads."""
    q, k, v, do = _qkv(rng, t)
    scale = 0.125
    out, vjp = jax.vjp(lambda a, b, c: flash_vjp.flash_attention(a, b, c, scale),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o, lse = attention.causal_attention_plain_lse(_t(q), _t(k), _t(v), scale)
    _close(o, out)
    got = attention.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, lse, _t(do), scale)
    for g, w in zip(got, want):
        _close(g, w)


def test_flash_lse_matches_the_forward_residual(rng):
    q, k, v, _ = _qkv(rng, 128, hq=8, g=2, b=2)
    out, res = flash_vjp._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125)
    _, lse = attention.causal_attention_plain_lse(_t(q), _t(k), _t(v), 0.125)
    # the JAX residual is (B, Hq, T, 1); the port keeps (B, Hq, T)
    _close(lse, np.asarray(res[4])[..., 0])


def test_flash_autograd_op_runs_the_plain_pair(rng):
    """causal_attention with grad on CPU tensors goes through FlashAttention
    and gives JAX's gradients."""
    q, k, v, do = _qkv(rng, 40, hq=8, g=2)
    _, vjp = jax.vjp(lambda a, b, c: flash_vjp.flash_attention(a, b, c, 0.125),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [_t(a, True) for a in (q, k, v)]
    out = attention.causal_attention(*leaves, 0.125)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * _t(do)).sum().backward()
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


def test_rms_norm_grads_match_jax(rng):
    x = rng.normal(size=(3, 17, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: rmsnorm_kernel.rms_norm(a, s, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale))
    want_x, want_s = vjp(jnp.asarray(g))
    tx, ts = _t(x, True), _t(scale, True)
    rmsnorm.rms_norm(tx, ts, 1e-5).backward(_t(g))
    _close(tx.grad, want_x)
    _close(ts.grad, want_s, atol=1e-4)  # a sum over 51 rows of O(1) terms


@pytest.mark.parametrize("n_elem", [64, 32])
def test_rope_grads_match_jax(rng, n_elem):
    """Partial rotary (n_elem 32 of 64) included: the tail passes through."""
    x = rng.normal(size=(2, 4, 16, 64)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    cos, sin = rope.build_rope_cache(16, n_elem, dtype=torch.float32)
    _, vjp = jax.vjp(lambda a: rope_kernel.apply_rope(a, jnp.asarray(cos.numpy()),
                                                      jnp.asarray(sin.numpy())),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = _t(x, True)
    rope.apply_rope(tx, cos, sin).backward(_t(g))
    _close(tx.grad, want)


@pytest.mark.parametrize("gate", ["silu", "gelu"])
def test_swiglu_grads_match_jax(rng, gate):
    d, inter = 64, 256  # inter a multiple of 256: the Pallas forward runs
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    w1, w2 = (rng.normal(size=(inter, d)).astype(np.float32) * 0.1 for _ in range(2))
    w3 = rng.normal(size=(d, inter)).astype(np.float32) * 0.1
    g = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: swiglu_kernel.swiglu_mlp(*a, gate),
                     *(jnp.asarray(a) for a in (x, w1, w2, w3)))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a, True) for a in (x, w1, w2, w3)]
    swiglu.swiglu_mlp(*leaves, gate=gate).backward(_t(g))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w, rtol=1e-5)


def test_swiglu_skips_frozen_weight_grads(rng):
    x = _t(rng.normal(size=(5, 64)), True)
    w1, w2 = _t(rng.normal(size=(128, 64))), _t(rng.normal(size=(128, 64)))
    w3 = _t(rng.normal(size=(64, 128)))
    swiglu.swiglu_mlp(x, w1, w2, w3).sum().backward()
    assert x.grad is not None and all(w.grad is None for w in (w1, w2, w3))
    got = swiglu.swiglu_mlp_bwd(x, w1, w2, w3, torch.ones(5, 64),
                                needs=(True, False, False, False))
    assert got[1:] == (None, None, None)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("mean_all", [False, True])
def test_cross_entropy_grads_match_jax(rng, chunk, mean_all):
    """chunk 4 of T=8 runs the chunked path; chunk 0 the full logits."""
    b, t, d, v = 2, 8, 16, 40
    hidden = rng.normal(size=(b, t, d)).astype(np.float32)
    w = rng.normal(size=(v, d)).astype(np.float32) * 0.3
    targets = rng.integers(0, v, size=(b, t)).astype(np.int32)
    targets[0, :3] = -1
    loss, vjp = jax.vjp(
        lambda h, ww: jce.chunked_cross_entropy(h, ww, jnp.asarray(targets), chunk,
                                                mean_all_tokens=mean_all),
        jnp.asarray(hidden), jnp.asarray(w))
    want_h, want_w = vjp(jnp.ones_like(loss))
    th, tw = _t(hidden, True), _t(w, True)
    got = cross_entropy.chunked_cross_entropy(th, tw, torch.from_numpy(targets), chunk,
                                              mean_all_tokens=mean_all)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-6)
    _close(th.grad, want_h, atol=1e-6, rtol=1e-5)
    _close(tw.grad, want_w, atol=1e-6, rtol=1e-5)


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.zeros(2, 3, 5, requires_grad=True)
    targets = torch.full((2, 3), cross_entropy.IGNORE_INDEX)
    assert float(cross_entropy.cross_entropy(logits, targets)) == 0.0


def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64).requires_grad_()


GRADCHECKS = {
    "flash_attention": lambda: (
        lambda q, k, v: attention.FlashAttention.apply(q, k, v, 0.125),
        (_f64(1, 4, 6, 64, seed=1), _f64(1, 2, 6, 64, seed=2), _f64(1, 2, 6, 64, seed=3))),
    "rms_norm": lambda: (lambda x, s: rmsnorm.rms_norm(x, s, 1e-5),
                         (_f64(4, 16, seed=4), _f64(16, seed=5))),
    "apply_rope": lambda: (
        lambda x: rope.apply_rope(x, *rope.build_rope_cache(5, 8, dtype=torch.float64)),
        (_f64(2, 3, 5, 12, seed=6),)),
    "swiglu_silu": lambda: (lambda *a: swiglu.swiglu_mlp(*a, gate="silu"),
                            (_f64(3, 8, seed=7), _f64(12, 8, seed=8), _f64(12, 8, seed=9),
                             _f64(8, 12, seed=10))),
    "swiglu_gelu": lambda: (lambda *a: swiglu.swiglu_mlp(*a, gate="gelu"),
                            (_f64(3, 8, seed=11), _f64(12, 8, seed=12), _f64(12, 8, seed=13),
                             _f64(8, 12, seed=14))),
    "cross_entropy": lambda: (
        lambda h, w: cross_entropy.chunked_cross_entropy(
            h, w, torch.tensor([[1, -1, 3, 0], [2, 2, -1, 4]]), 2),
        (_f64(2, 4, 6, seed=15), _f64(5, 6, seed=16))),
}


@pytest.mark.parametrize("name", GRADCHECKS)
def test_gradcheck_float64(name):
    fn, inputs = GRADCHECKS[name]()
    assert torch.autograd.gradcheck(fn, inputs)
