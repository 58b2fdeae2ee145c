"""The port's ops (plain PyTorch versions of its kernels) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances: fp32 atol 1e-5 (the same arithmetic, sums in another order);
bf16 atol 2e-2 (inputs rounded identically, outputs may differ by a bf16
ulp where the two round at different points, e.g. the flash kernel keeps P
in fp32 where the port's plain version rounds it to bf16 as XLA's does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu import ops as jops
from dualhyp_tpu.ops import attention as jattn
from dualhyp_tpu.ops import use_backend
from dualhyp_tpu.ops.pallas import flash_vjp, rope_kernel, swiglu_kernel
from dualhyp_tpu_torch.ops import attention, rmsnorm, rope, swiglu

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, name):
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _close(got, want, name):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=0,
        atol=DTYPES[name][2])


@pytest.mark.parametrize("name", DTYPES)
def test_rms_norm_matches_pallas(rng, name):
    # 300 rows: not a multiple of the Pallas kernel's 256-row block
    x = rng.normal(size=(3, 100, 128)).astype(np.float32)
    scale = rng.normal(size=(128,)).astype(np.float32)
    jx, tx = _both(x, name)
    with use_backend("pallas"):
        want = jops.rms_norm(jx, jnp.asarray(scale), 1e-5)
    got = rmsnorm.rms_norm(tx, torch.from_numpy(scale), 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, name)


def test_layer_norm_matches_jax(rng):
    from dualhyp_tpu.ops.rmsnorm import layer_norm

    x = rng.normal(size=(5, 48)).astype(np.float32)
    s, b = rng.normal(size=(2, 48)).astype(np.float32)
    want = layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)
    got = rmsnorm.layer_norm(*(torch.from_numpy(a) for a in (x, s, b)), 1e-5)
    _close(got, want, "fp32")


@pytest.mark.parametrize("n_elem", [64, 32])
def test_rope_cache_matches_jax(n_elem):
    jcos, jsin = jops.build_rope_cache(40, n_elem, base=10000, condense_ratio=2,
                                       dtype=jnp.float32)
    cos, sin = rope.build_rope_cache(40, n_elem, base=10000, condense_ratio=2,
                                     dtype=torch.float32)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("n_elem", [64, 32])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_rope_matches_pallas(rng, name, n_elem, transpose):
    x = rng.normal(size=(2, 4, 16, 64)).astype(np.float32)
    ang = rng.uniform(-3, 3, size=(16, n_elem)).astype(np.float32)
    jx, tx = _both(x, name)
    jcos, tcos = _both(np.cos(ang), name)
    jsin, tsin = _both(np.sin(ang), name)
    want = rope_kernel._run(jx, jcos, jsin, transpose=transpose)
    got = rope.apply_rope(tx, tcos, tsin, transpose=transpose)
    _close(got, want, name)


def test_apply_rope_gathered_matches_jax_decode_path(rng):
    x = rng.normal(size=(3, 4, 1, 32)).astype(np.float32)
    cos, sin = rope.build_rope_cache(20, 16, dtype=torch.float32)
    positions = np.array([0, 7, 19])
    cos_b = jnp.asarray(cos.numpy()[positions])[:, None, None, :]
    sin_b = jnp.asarray(sin.numpy()[positions])[:, None, None, :]
    with use_backend("xla"):
        want = jops.apply_rope(jnp.asarray(x), cos_b, sin_b)
    got = rope.apply_rope_gathered(torch.from_numpy(x), cos, sin,
                                   torch.from_numpy(positions))
    _close(got, want, "fp32")


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("gate", ["silu", "gelu"])
def test_swiglu_matches_pallas(rng, name, gate):
    d, inter = 64, 256
    x = rng.normal(size=(2, 9, d)).astype(np.float32)
    w1, w2 = (rng.normal(size=(inter, d)).astype(np.float32) * 0.1 for _ in range(2))
    w3 = rng.normal(size=(d, inter)).astype(np.float32) * 0.1
    # the interpret-mode kernel gets weights already in x's dtype, as the
    # port keeps them
    args = [_both(a, name) for a in (x, w1, w2, w3)]
    want = swiglu_kernel.swiglu_mlp(*(a[0] for a in args), gate)
    got = swiglu.swiglu_mlp(*(a[1] for a in args), gate=gate)
    _close(got, want, name)


def test_linear_matches_jax(rng):
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(8, 16)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    want = jops.swiglu.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = swiglu.linear(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got, want, "fp32")


def _qkv(rng, t):
    q = rng.normal(size=(1, 4, t, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, t, 16)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("name", DTYPES)
def test_causal_attention_matches_flash_kernel(rng, name):
    # T = 128: the JAX package runs its Pallas flash kernel
    args = [_both(a, name) for a in _qkv(rng, 128)]
    want = flash_vjp.flash_attention(*(a[0] for a in args), 0.25)
    got = attention.causal_attention(*(a[1] for a in args), 0.25)
    _close(got, want, name)


@pytest.mark.parametrize("name", DTYPES)
def test_causal_attention_ragged_matches_xla(rng, name):
    # T = 96: the JAX kernel needs T % 128 == 0 and falls back to XLA
    args = [_both(a, name) for a in _qkv(rng, 96)]
    want = jattn._causal_attention_xla(*(a[0] for a in args), 0.25)
    got = attention.causal_attention(*(a[1] for a in args), 0.25)
    _close(got, want, name)


@pytest.mark.parametrize("name", DTYPES)
def test_decode_attention_matches_jax(rng, name):
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 2, 12, 16)).astype(np.float32) for _ in range(2))
    kv_length = np.array([5, 12])
    args = [_both(a, name) for a in (q, kc, vc)]
    want = jattn.decode_attention(*(a[0] for a in args), jnp.asarray(kv_length))
    got = attention.decode_attention(*(a[1] for a in args), torch.from_numpy(kv_length))
    _close(got, want, name)


def test_wrappers_take_the_plain_version_only_on_cpu():
    # a tensor that is neither on the CPU nor on a CUDA card is refused, not
    # computed by the plain version
    x = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.rms_norm(x, torch.ones(64, device="meta"))
