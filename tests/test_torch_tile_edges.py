"""K1's forward and K4 at the edges of their Hopper kernels' tiles, on the CPU.

On the card the wgmma/TMA kernels (`csrc/flash_attention.cu`,
`csrc/swiglu.cu`) are held to the plain versions (`test_torch_kernels.py`,
`chip_smoke.py`). Here the plain versions are held to the JAX package's
Pallas kernels in interpret mode at the shapes where the kernels change
path or tile: K4 on both sides of its decode path (at most
`swiglu.DECODE_ROWS` rows, operands swapped) and a ragged intermediate size
(the JAX package's jnp path there), K1's O and row logsumexp L at head
sizes 64 and 128 and GQA ratios 1 and 4; and the wrapper's copy of an input
TMA cannot read.

Tolerances: fp32 on both sides, the same arithmetic summed in another order
(atol 1e-5; 1e-4 for L, a log of sums over up to 256 keys).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.ops.pallas import flash_vjp, swiglu_kernel
from dualhyp_tpu_torch.ops import attention, swiglu


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _weights(rng, d, inter):
    w1, w2 = (rng.normal(size=(inter, d)).astype(np.float32) * 0.1 for _ in range(2))
    return w1, w2, rng.normal(size=(d, inter)).astype(np.float32) * 0.1


@pytest.mark.parametrize("rows", [1, 8, 64, 65, 130])
@pytest.mark.parametrize("gate", ["silu", "gelu"])
def test_swiglu_plain_matches_pallas_across_the_decode_edge(rng, rows, gate):
    assert swiglu.DECODE_ROWS == 64
    x = rng.normal(size=(rows, 64)).astype(np.float32)
    args = (x, *_weights(rng, 64, 256))
    want = swiglu_kernel.swiglu_mlp(*(jnp.asarray(a) for a in args), gate)
    _close(swiglu.swiglu_mlp(*(torch.from_numpy(a) for a in args), gate=gate), want)


@pytest.mark.parametrize("rows", [8, 65])
def test_swiglu_plain_matches_jax_at_a_ragged_inter(rng, rows):
    # inter 200: a partial last tile of W3's contraction on the card; the
    # JAX package takes its jnp path (200 is not a multiple of its block)
    x = rng.normal(size=(rows, 64)).astype(np.float32)
    args = (x, *_weights(rng, 64, 200))
    want = swiglu_kernel.swiglu_mlp(*(jnp.asarray(a) for a in args), "silu")
    _close(swiglu.swiglu_mlp(*(torch.from_numpy(a) for a in args)), want)


@pytest.mark.parametrize("d,t", [(64, 128), (64, 256), (128, 128)])
@pytest.mark.parametrize("q_per_kv", [1, 4])
def test_flash_forward_plain_matches_pallas_o_and_lse(rng, d, t, q_per_kv):
    q = rng.normal(size=(1, 4, t, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, 4 // q_per_kv, t, d)).astype(np.float32) for _ in range(2))
    scale = float(d) ** -0.5
    want_o, (_, _, _, _, want_lse) = flash_vjp._forward(
        *(jnp.asarray(a) for a in (q, k, v)), scale)
    o, lse = attention.causal_attention_plain_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), scale)
    _close(o, want_o)
    _close(lse, np.asarray(want_lse)[..., 0], atol=1e-4)


def test_swiglu_wrapper_copies_only_an_unaligned_input():
    flat = torch.arange(1 + 4 * 64, dtype=torch.bfloat16)
    unaligned = flat[1:].view(4, 64)
    assert unaligned.data_ptr() % 16
    copy = swiglu._aligned(unaligned)
    assert copy.data_ptr() % 16 == 0 and copy.is_contiguous()
    assert torch.equal(copy, unaligned)
    aligned = flat[:64 * 4].view(4, 64)
    assert swiglu._aligned(aligned) is aligned
