"""K2 (RMSNorm) and K3 (RoPE) at the paths of their Hopper kernels, on the CPU.

On the card the kernels (`csrc/rmsnorm.cu`, `csrc/rope.cu`) are held to the
plain versions (`test_torch_kernels.py`, `chip_smoke.py`). Here:
- the wrappers' launch plans: which instance a shape takes (16-byte vectors
  or one element an access; K2's row held in registers or read twice) and
  K3's block, at the main path's shapes and at the edges the card tests
  drive (d not a multiple of a vector, a view offset by one element,
  n_elem 16 and 32 of a 64-wide head, k's few heads);
- the plain versions against the JAX package's Pallas kernels in interpret
  mode at those shapes: K2 at widths on both sides of the registers'
  reach (4096 bf16 and past it) and at an odd width, K3 on q and k views of
  a fused QKV projection at T 1 and 37, both directions.

Tolerances as `test_torch_ops.py`: fp32 atol 1e-5 (the same arithmetic,
sums in another order), bf16 atol 2e-2 (a bf16 ulp where the two round at
different points).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu import ops as jops
from dualhyp_tpu.ops import use_backend
from dualhyp_tpu.ops.pallas import rope_kernel
from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.models.gpt import split_heads
from dualhyp_tpu_torch.ops import rmsnorm, rope

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
H100_SMS = 132


def _close(got, want, name):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=DTYPES[name][2])


# (d, bytes an element, byte offset of x) -> (width, held)
ROW_PLANS = {
    "tinyllama_bf16": ((2048, 2, 0), (8, 8)),
    "mixtral_bf16": ((4096, 2, 0), (8, 16)),
    "past_the_registers_bf16": ((4104, 2, 0), (8, 0)),
    "narrow_bf16": ((64, 2, 0), (8, 1)),
    "d256_bf16": ((256, 2, 0), (8, 1)),
    "d264_bf16": ((264, 2, 0), (8, 2)),
    "odd_width_bf16": ((1003, 2, 0), (1, 0)),
    "offset_by_one_bf16": ((2048, 2, 2), (1, 0)),
    "tinyllama_fp32": ((2048, 4, 0), (4, 16)),
    "mixtral_fp32": ((4096, 4, 0), (4, 0)),
    "d6_fp32": ((6, 4, 0), (1, 0)),
    "offset_by_one_fp32": ((256, 4, 4), (1, 0)),
}


@pytest.mark.parametrize("case", list(ROW_PLANS))
def test_rms_norm_row_plan(case):
    (d, itemsize, offset), want = ROW_PLANS[case]
    assert rmsnorm.row_plan(3072, d, itemsize, 4096 + offset, 8192, 12288) == (*want, 4, 1)
    # the row of a vector path is read once wherever 32 lanes can hold it
    width, held = want
    if width > 1 and d // width <= 32 * rmsnorm.MAX_HELD:
        assert held and 32 * held * width >= d and (held == 1 or 16 * held * width < d)


def test_rms_norm_row_plan_reads_the_scale_and_output_pointers():
    assert rmsnorm.row_plan(3072, 2048, 2, 0, 4, 0) == (1, 0, 4, 1)
    assert rmsnorm.row_plan(3072, 2048, 2, 0, 0, 8) == (1, 0, 4, 1)


# rows -> K2's plan at width 2048 bf16: a row a block over 8 warps below
# FEW_ROWS rows, 4 rows a block of one warp each from there on
@pytest.mark.parametrize("rows,plan", [(1, (8, 1, 1, 8)), (8, (8, 1, 1, 8)),
                                       (511, (8, 1, 1, 8)), (512, (8, 8, 4, 1)),
                                       (3072, (8, 8, 4, 1)), (8192, (8, 8, 4, 1))])
def test_rms_norm_row_plan_spreads_a_few_rows_over_the_sms(rows, plan):
    assert rmsnorm.row_plan(rows, 2048, 2, 0, 0, 0) == plan
    per_block = plan[2]
    assert rmsnorm.row_plan(rows, 1003, 2, 0, 0, 0) == (1, 0, per_block, 1)
    # Mixtral's width: two vectors a lane of 8 warps; narrow rows: one warp
    assert rmsnorm.row_plan(rows, 4096, 2, 0, 0, 0) == (
        (8, 2, 1, 8) if per_block == 1 else (8, 16, 4, 1))
    assert rmsnorm.row_plan(rows, 256, 2, 0, 0, 0) == (8, 1, per_block, 1)


def _strides(view):
    x5 = view.reshape((1,) * (5 - view.dim()) + tuple(view.shape))
    return [s if n > 1 else 0 for n, s in zip(x5.shape[:4], x5.stride()[:4])], x5.shape[:3]


def _qkv_views(n_embd, n_head, groups, b=8, t=1024):
    cfg = GPTConfig(n_embd=n_embd, n_head=n_head, n_query_groups=groups,
                    intermediate_size=256, mlp_class="LLaMAMLP")
    q5, k4, _ = split_heads(cfg, torch.empty(b, t, cfg.qkv_out_dim, device="meta"))
    return q5, k4


# (model, view, n_elem) -> (width, row_threads, t_block, heads_per_block) at T 1024 bf16
ROPE_PLANS = {
    ("tinyllama", "q", 64): (8, 4, 64, 10),
    ("tinyllama", "k", 64): (8, 4, 64, 1),
    ("mixtral", "q", 128): (8, 8, 32, 16),
    ("mixtral", "k", 128): (8, 8, 32, 5),
    ("tinyllama", "q", 32): (8, 6, 42, 16),
    ("tinyllama", "q", 16): (8, 7, 36, 16),
}
MODELS = {"tinyllama": (2048, 32, 4), "mixtral": (4096, 32, 8)}


@pytest.mark.parametrize("case", list(ROPE_PLANS))
def test_rope_launch_plan_at_the_training_shapes(case):
    model, which, n_elem = case
    q5, k4 = _qkv_views(*MODELS[model])
    view = q5 if which == "q" else k4
    strides, lead = _strides(view)
    heads = lead[0] * lead[1] * lead[2]
    plan = rope.launch_plan(heads, 1024, view.shape[-1], n_elem, 2, strides, (0, 16, 32, 48),
                            H100_SMS)
    assert plan == ROPE_PLANS[case]
    width, row_threads, t_block, heads_per_block = plan
    # one thread a vector of the first half with its partner, or a copied vector
    assert row_threads == (n_elem // 2 + view.shape[-1] - n_elem) // width
    assert row_threads * t_block <= rope.BLOCK_THREADS
    blocks = -(-heads // heads_per_block) * -(-1024 // t_block)
    assert blocks >= H100_SMS


@pytest.mark.parametrize("case", ["n_elem_8", "odd_stride", "offset_by_one", "fp32_n_elem_4",
                                  "head_size_12"])
def test_rope_launch_plan_takes_one_element_an_access(case):
    args = {"n_elem_8": (64, 8, 2, [0, 64, 64 * 64, 64]),
            "odd_stride": (64, 64, 2, [0, 0, 0, 68 + 1]),
            "offset_by_one": (64, 64, 2, [0, 0, 0, 64]),
            "fp32_n_elem_4": (64, 4, 4, [0, 0, 0, 64]),
            "head_size_12": (12, 12, 2, [0, 0, 0, 12])}[case]
    d, n_elem, itemsize, strides = args
    x_ptr = 4096 + (itemsize if case == "offset_by_one" else 0)
    width, row_threads, t_block, _ = rope.launch_plan(
        4, 37, d, n_elem, itemsize, strides, (x_ptr, 0, 16, 32), H100_SMS)
    assert width == 1
    assert row_threads == n_elem // 2 + d - n_elem and t_block * row_threads <= 256


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("d", [64, 1003, 4096, 4104])
def test_rms_norm_plain_matches_pallas_at_the_kernel_paths(rng, name, d):
    x = rng.normal(size=(7, d)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    jdt, tdt, _ = DTYPES[name]
    with use_backend("pallas"):
        want = jops.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale), 1e-5)
    got = rmsnorm.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale), 1e-5)
    assert got.dtype == tdt
    _close(got, want, name)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("d,n_elem", [(64, 16), (64, 32), (64, 64), (128, 128)])
@pytest.mark.parametrize("t", [1, 37])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_rope_plain_matches_pallas_on_fused_qkv_views(rng, name, d, n_elem, t,
                                                            transpose):
    cfg = GPTConfig(n_embd=4 * d, n_head=4, n_query_groups=2, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    qkv = rng.normal(size=(2, t, cfg.qkv_out_dim)).astype(np.float32)
    ang = rng.uniform(-3, 3, size=(t, n_elem)).astype(np.float32)
    jdt, tdt, _ = DTYPES[name]
    tcos, tsin = (torch.from_numpy(f(ang)).to(tdt) for f in (np.cos, np.sin))
    q5, k4, _ = split_heads(cfg, torch.from_numpy(qkv).to(tdt))
    for view in (q5, k4):
        want = rope_kernel._run(jnp.asarray(view.float().numpy(), jdt),
                                jnp.asarray(np.cos(ang), jdt), jnp.asarray(np.sin(ang), jdt),
                                transpose=transpose)
        got = rope.apply_rope(view, tcos, tsin, transpose=transpose)
        assert got.is_contiguous() and got.shape == view.shape
        _close(got, want, name)
