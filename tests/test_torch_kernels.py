"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases the main path's shapes do not reach: ragged sequence lengths and
row counts, partial rotary, the inverse rotation, K2 and K3 on each of
their instances (rows held in registers, read twice, split over 8 warps,
one element an access for odd widths and views offset by one element;
n_elem 16 to 128 of cos/sin tables whose halves differ) with bitwise
repeats, a ragged intermediate
size, the gelu gate, strided inputs, fp32 where a kernel takes it, the
wrappers' refusals, the autograd ops of the training path, K8 at ragged
rows and N with split K (1 to 3072 rows around its 16-row decode kernel
and its 128-token tile, K of one and five groups), K8 at 1 to 16 rows and
K5 at 1, 8 and 16 rows (s 0, 0.75 and 2, xin shared and separate) at the
int4 and fused slices' shapes and at 17 to 32 rows (its decode kernel's
most), both at 8 rows repeating bitwise in one CUDA kernel a call without
a host sync, K8 and L2's
forward and lhs gradient repeating bitwise at 3072 rows, K5 at ragged
rows and O, ranks 4, 8, 16, 40, 48 and 64, a zero scale and a separate LoRA
input, rows 33 to 1536 around its wgmma kernels' tiles, an unaligned
input, bitwise repeats at 3072 rows and no host wait forward or backward,
and K6/K7 in fp32 and bf16 at T or
S of 1, 63, 64, 65 and 1500, S != T, kv_valid and strided inputs, K6 at
fp32 at the RelPrompt shape (B1 H20 T=S=280) repeating bitwise, K6/K7 at
fp32 on logits up to ~130 (where TF32 or two bf16 pieces miss), L2
(the grouped matmul) at M of 0, 1, 8, 16, 17, 32, 64, 65, 300 and 6144 with
empty, straddling and single groups, groups of 127, 128 and 129 rows
around its 128-row tile, a ragged N and a K of 14336 that its decode
kernel splits over a cluster, rows past the last group at 1 to 65 rows,
its forward at 16 rows repeating bitwise in one CUDA kernel a call
without a host sync, its two gradients
(dlhs, drhs) at M from 0 to 16384, drhs at groups of 63 to 129 rows
around its 64-row step with rows past the last group, repeating bitwise
at 16384 rows, K1's forward and backward at head size
128, a small MoE model card against CPU, in prefill and in a LoRA
training step, L1 (splash attention: forward, dQ, dK/dV) at T of 1, 63,
64, 65, 127, 128, 129, 192, 200, 256 and 1024, head sizes 64 and 128, 4
and 8 KV groups, the kernels at scale 1 and at the softmax scale, dQ and
dK/dV repeating bitwise, strided views, refusals, and its autograd op card
against CPU, and the wgmma/TMA designs of K1's forward (T from 1 to 1024 around its tile
edges, head sizes 64 and 128, GQA ratios 1, 4, 8, fused-QKV views), K1's
backward and L1's forward (T 127, 128, 129 and 256 at the edges of their
64- and 128-key blocks, an unaligned input copied, one launch a call) and
K4 (1 to 3072 rows at widths 128 and 2048, inter 200, 256 and 5632, both
gates, bitwise repeats, an unaligned input), K1 and L1 at the registry's
other head sizes (32, 80, 96, 100 through a padded copy, 256) with MHA,
MQA and 7 or 71 query heads in one group, fused-QKV views and the autograd
op, K1's backward and L1's dK/dV at 80 and 96 (narrow boxes, 128-key
blocks) at T about those blocks with bitwise dK/dV repeats, K8's middle
kernel at 17 to MID_ROWS rows of the verify step's and the Whisper beam's
shapes (ragged and strided x, bitwise repeats, one launch on the path the
dispatch names), K3 at the registry's partial rotary pairs and K5 and K8 at
phi-2's shapes, and K5's and K4's middle paths (csrc/mid_matmul.cuh) around
each crossing (K5 32/33, 144, 192/193; K4 64/65, 144/145) at a verify
step's shapes and at a ragged O and `inter`, both gates, s of 0, 0.75 and
2 with a separate xin, bitwise repeats, each path's launch count, no host
sync, and one CUDA kernel a K5 call, two a K4 call. Every test needs an NVIDIA
card and skips without one. On the card's machine (no JAX there) run them
without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

and the spread of the small-MoE card-vs-CPU training step over LoRA draws
(one JSON line a draw; the test's own step with `--rows 16 --tokens 16
--hold-alike`) with

    python -m tests.test_torch_kernels --moe-draws 100

Tolerances are elementwise |kernel - plain| <= atol + rtol * |plain|: bf16
outputs may round apart by a bf16 ulp or two (rtol 2^-7 or 2^-6), fp32
outputs differ by summation order only. The K1 backward's atol is 2^-4 of
the gradient's RMS plus 2^-10: it rounds P and dS to bf16 before sums over
up to q_per_kv * T terms, and where the exact gradient is zero (dQ and dK
at T=1) both sides hold fp32 noise (see chip_smoke.py's FLASH_BWD_TOL).
"""

import math

import pytest
import torch

from chip_smoke import mixtral_routes, prefill_with_routes
from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.models.gpt import GPT, split_heads
from dualhyp_tpu_torch.ops import (attention, flash_fwd, gmm, int4, lora, quant, rmsnorm,
                                   rope, splash, swiglu)

pytestmark = pytest.mark.cuda

BF16 = (torch.bfloat16, 1e-3, 2.0 ** -7)
F32 = (torch.float32, 1e-5, 1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16, std=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


def _close(got, want, atol, rtol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    assert bool((diff <= bound).all()), f"max abs err {float(diff.max())}"


# K2: widths held in registers (64 to 4096 bf16, to 2048 fp32), read twice
# (4096 fp32) and one element a load (1003); rows at one row a block (2048
# and 4096 bf16, 2048 fp32: split over 8 warps) and at 4 (3077, not a
# multiple of 4)
@pytest.mark.parametrize("dtype,atol,rtol", [BF16, F32])
@pytest.mark.parametrize("rows", [1, 7, 300, 3077])
@pytest.mark.parametrize("d", [64, 256, 1003, 2048, 4096])
def test_rms_norm(dev, gen, dtype, atol, rtol, rows, d):
    x = _randn(gen, rows, d, dtype=dtype)
    scale = 1.0 + _randn(gen, d, dtype=torch.float32, std=0.1)
    _close(rmsnorm.rms_norm(x, scale), rmsnorm.rms_norm_plain(x, scale), atol, rtol)


def test_rms_norm_strided_input(dev, gen):
    x = _randn(gen, 256, 40).t()  # (40, 256) with a non-unit channel stride
    scale = torch.ones(256, device=dev)
    _close(rmsnorm.rms_norm(x, scale), rmsnorm.rms_norm_plain(x, scale), *BF16[1:])


@pytest.mark.parametrize("dtype,atol,rtol", [BF16, F32])
@pytest.mark.parametrize("d", [256, 2048])
def test_rms_norm_reads_a_view_offset_by_one_element(dev, gen, dtype, atol, rtol, d):
    x = _randn(gen, 37 * d + 1, dtype=dtype)[1:].view(37, d)
    scale = 1.0 + _randn(gen, d, dtype=torch.float32, std=0.1)
    assert rmsnorm.row_plan(37, d, x.element_size(), x.data_ptr(), scale.data_ptr(), 0)[:2] == (
        1, 0)
    _close(rmsnorm.rms_norm(x, scale), rmsnorm.rms_norm_plain(x, scale), atol, rtol)


def _rope_tables(gen, t, n_elem, dtype):
    """cos and sin of random angles: the two halves of a row differ, as
    K3 must not assume the tables tiled twice."""
    ang = torch.rand(t, n_elem, generator=gen, device=gen.device) * 6 - 3
    return ang.cos().to(dtype), ang.sin().to(dtype)


# K3: 16-byte vectors at n_elem 16, 32 and 64 of a 64-wide head (the rest
# copied) and 128 of 128; every (head size, rotary channels) pair of the
# registry: (128, 32) pythia-1.4b to -12b and dolly-v2, (80, 80) RedPajama,
# (96, 96) Phi-3, (100, 100) open_llama_3b (50 channels a half: the scalar
# path), (256, 256) Gemma; one position, a ragged T and the training T; q
# and k views of the fused QKV projection and a contiguous gradient
@pytest.mark.parametrize("dtype,atol,rtol", [BF16, F32])
@pytest.mark.parametrize("d,n_elem", [(64, 16), (64, 32), (64, 64), (128, 128),
                                     (80, 20), (80, 32), (32, 8), (256, 64),
                                     (128, 32), (80, 80), (96, 96), (100, 100),
                                     (256, 256)])
@pytest.mark.parametrize("t", [1, 37, 1024])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_rope_on_fused_qkv_heads(dev, gen, dtype, atol, rtol, d, n_elem, t, transpose):
    cfg = GPTConfig(n_embd=8 * d, n_head=8, n_query_groups=2, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    qkv = _randn(gen, 3, t, cfg.qkv_out_dim, dtype=dtype)
    q5, k4, v4 = split_heads(cfg, qkv)
    cos, sin = _rope_tables(gen, t, n_elem, dtype)
    for x in (q5, k4, v4.contiguous()):
        got = rope.apply_rope(x, cos, sin, transpose=transpose)
        assert got.is_contiguous()
        _close(got, rope.apply_rope_plain(x, cos, sin, transpose), atol, rtol)


@pytest.mark.parametrize("dtype,atol,rtol", [BF16, F32])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_rope_reads_a_view_offset_by_one_element(dev, gen, dtype, atol, rtol, transpose):
    x = _randn(gen, 2 * 4 * 37 * 64 + 1, dtype=dtype)[1:].view(2, 4, 37, 64)
    cos, sin = _rope_tables(gen, 37, 64, dtype)
    assert rope.launch_plan(8, 37, 64, 64, x.element_size(), [0, 4 * 37 * 64, 37 * 64, 64],
                            (x.data_ptr(), cos.data_ptr(), sin.data_ptr(), 0), 132)[0] == 1
    _close(rope.apply_rope(x, cos, sin, transpose=transpose),
           rope.apply_rope_plain(x, cos, sin, transpose), atol, rtol)


@pytest.mark.parametrize("case", ["rms_norm", "rms_norm_read_twice", "apply_rope",
                                  "apply_rope_transpose"])
def test_rms_norm_and_rope_repeat_bitwise(dev, gen, case):
    """Two launches on the same inputs give the same bits (no atomics)."""
    if case.startswith("rms_norm"):
        d = 2048 if case == "rms_norm" else 4104
        x = _randn(gen, 3077, d)
        scale = 1.0 + _randn(gen, d, dtype=torch.float32, std=0.1)
        first, second = (rmsnorm.rms_norm(x, scale) for _ in range(2))
    else:
        cfg = GPTConfig(n_embd=2048, n_head=32, n_query_groups=4, intermediate_size=256,
                        mlp_class="LLaMAMLP")
        q5, _, _ = split_heads(cfg, _randn(gen, 2, 1024, cfg.qkv_out_dim))
        cos, sin = _rope_tables(gen, 1024, 64, torch.bfloat16)
        tr = case == "apply_rope_transpose"
        first, second = (rope.apply_rope(q5, cos, sin, transpose=tr) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("transpose", [False, True])
def test_apply_rope_at_head_size_128(dev, gen, transpose):
    """K3 on Mixtral's heads (head size 128, 4 query heads a group, rope
    base 1e6), both directions."""
    cfg = GPTConfig(n_embd=1024, n_head=8, n_query_groups=2, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    q5, k4, _ = split_heads(cfg, _randn(gen, 2, 70, cfg.qkv_out_dim))
    cos, sin = rope.build_rope_cache(70, 128, base=1000000, dtype=torch.bfloat16, device=dev)
    for x in (q5, k4):
        _close(rope.apply_rope(x, cos, sin, transpose=transpose),
               rope.apply_rope_plain(x, cos, sin, transpose), *BF16[1:])


def test_rope_transpose_inverts(dev, gen):
    x = _randn(gen, 2, 4, 16, 64, dtype=torch.float32)
    cos, sin = rope.build_rope_cache(16, 64, dtype=torch.float32, device=dev)
    back = rope.apply_rope(rope.apply_rope(x, cos, sin), cos, sin, transpose=True)
    _close(back, x, 1e-5, 1e-5)


# K1's forward: T on both sides of its 64-row warpgroup and 64-key tile
# edges, head sizes 64 and 128, GQA ratios 4, 1 and 8.
@pytest.mark.parametrize("t", [1, 17, 63, 64, 65, 127, 128, 129, 200, 1024])
@pytest.mark.parametrize("hq,g", [(8, 2), (4, 4), (8, 8), (8, 1)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention(dev, gen, t, hq, g, d):
    q = _randn(gen, 2, hq, t, d)
    k = _randn(gen, 2, g, t, d)
    v = _randn(gen, 2, g, t, d)
    scale = 1.0 / math.sqrt(d)
    before = attention.FLASH_FWD.launches
    o, lse = attention._flash_fwd(q, k, v, scale)
    assert attention.FLASH_FWD.launches == before + 1
    _close(o, attention.causal_attention_plain(q, k, v, scale), 1e-2, 2.0 ** -6)
    logits = torch.matmul(q.float().reshape(2, g, hq // g, t, d),
                          k.float()[:, :, None].transpose(-1, -2)) * scale
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    want_lse = torch.logsumexp(logits.masked_fill(~causal, float("-inf")), dim=-1)
    _close(lse, want_lse.reshape(2, hq, t), 1e-4, 1e-5)


@pytest.mark.parametrize("d", attention.FLASH_HEAD_SIZES)
@pytest.mark.parametrize("groups", [2, 8])
def test_flash_attention_reads_fused_qkv_views(dev, gen, d, groups):
    """k and v (and q, at one query head a group) as strided views of the
    fused QKV projection; O comes back as a view of a (B, T, H, D) buffer."""
    cfg = GPTConfig(n_embd=8 * d, n_head=8, n_query_groups=groups, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    qkv = _randn(gen, 2, 70, cfg.qkv_out_dim)
    q5, k, v = split_heads(cfg, qkv)
    q = q5.reshape(2, 8, 70, d)
    assert not k.is_contiguous() and q.is_contiguous() == (groups != 8)
    got = attention.causal_attention(q, k, v)
    # head size 100 comes back as a view of the (B, T, H, 104) padded buffer
    assert got.transpose(1, 2).is_contiguous() == (attention.padded_head_size(d) == d)
    _close(got, attention.causal_attention_plain(q, k, v), 1e-2, 2.0 ** -6)


def test_flash_attention_refuses_what_it_does_not_take(dev, gen):
    with pytest.raises(ValueError, match="head size"):
        attention.causal_attention(*(_randn(gen, 1, 2, 8, 48) for _ in range(3)))
    with pytest.raises(TypeError, match="bfloat16"):
        attention.causal_attention(*(_randn(gen, 1, 2, 8, 64, dtype=torch.float32)
                                     for _ in range(3)))


# K4: decode rows (operands swapped, the down product split over `inter`)
# up to the 64-row edge of that path, prefill rows past a 128-row tile, a
# ragged and a full `inter`, TinyLlama's width and a narrow one, both gates.
@pytest.mark.parametrize("rows", [1, 8, 63, 64, 65, 130, 3072])
@pytest.mark.parametrize("inter", [256, 200, 5632])
@pytest.mark.parametrize("gate", ["silu", "gelu"])
@pytest.mark.parametrize("d,std", [(128, 0.05), (2048, 0.02)])
def test_swiglu(dev, gen, rows, inter, gate, d, std):
    x = _randn(gen, rows, d)
    w1, w2 = (_randn(gen, inter, d, std=std) for _ in range(2))
    w3 = _randn(gen, d, inter, std=std)
    before = swiglu.SWIGLU.launches
    got = swiglu.swiglu_mlp(x, w1, w2, w3, gate)
    assert swiglu.SWIGLU.launches == before + 1
    _close(got, swiglu.swiglu_mlp_plain(x, w1, w2, w3, gate), 1e-2, 2.0 ** -6)


@pytest.mark.parametrize("rows", [8, 65, 3072])
def test_swiglu_repeats_bitwise(dev, gen, rows):
    """No atomics: two calls on the same inputs give the same bits."""
    x = _randn(gen, rows, 2048)
    w1, w2 = (_randn(gen, 5632, 2048, std=0.02) for _ in range(2))
    w3 = _randn(gen, 2048, 5632, std=0.02)
    assert torch.equal(swiglu.swiglu_mlp(x, w1, w2, w3), swiglu.swiglu_mlp(x, w1, w2, w3))


def test_swiglu_takes_an_unaligned_batched_input(dev, gen):
    """x of shape (B, T, d) starting 2 bytes past a 16-byte boundary (TMA
    needs aligned rows: the wrapper copies it)."""
    flat = _randn(gen, 1 + 2 * 33 * 128)
    x = flat[1:].view(2, 33, 128)
    assert x.data_ptr() % 16
    w1, w2 = (_randn(gen, 200, 128, std=0.05) for _ in range(2))
    w3 = _randn(gen, 128, 200, std=0.05)
    got = swiglu.swiglu_mlp(x, w1, w2, w3)
    assert got.shape == x.shape
    _close(got, swiglu.swiglu_mlp_plain(x, w1, w2, w3), 1e-2, 2.0 ** -6)


def test_swiglu_refuses_unaligned_width(dev, gen):
    x = _randn(gen, 4, 96)
    w = _randn(gen, 64, 96)
    with pytest.raises(ValueError, match="d % 64"):
        swiglu.swiglu_mlp(x, w, w, _randn(gen, 96, 64))


# K6/K7 (flash_fwd): fp32 against the fp32 plain version (sums of the
# three-piece bf16 products in another order, exp2f against torch.exp:
# ~1e-6 on unit-normal inputs; 1e-4 as chip_smoke.py holds it); bf16 keeps P in fp32 for the P V product (hi + lo
# halves, each a bf16 product) as the plain version does, and both round the
# output once: one bf16 ulp apart at most (rtol 2^-7), near-zero outputs of
# cancelling terms by the fp32 sums' order (atol), as L1's forward.
FWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s", [(1, 1), (63, 63), (64, 64), (65, 65), (1500, 1500),
                                 (65, 1), (1, 200), (200, 63), (300, 1500)])
def test_full_attention_fwd(dev, gen, dtype, t, s):
    q, k, v = _randn(gen, 2, 3, t, 64, dtype=dtype), *(
        _randn(gen, 2, 3, s, 64, dtype=dtype) for _ in range(2))
    before = flash_fwd.FLASH_FULL.launches
    got = flash_fwd.full_attention_fwd(q, k, v)
    assert flash_fwd.FLASH_FULL.launches == before + 1
    _close(got, flash_fwd.full_attention_plain(q, k, v), *FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_attention_fwd_masks_keys_past_kv_valid(dev, gen, dtype):
    q, k, v = (_randn(gen, 1, 2, 130, 64, dtype=dtype) for _ in range(3))
    for kv_valid in (1, 64, 100):
        _close(flash_fwd.full_attention_fwd(q, k, v, kv_valid=kv_valid),
               flash_fwd.full_attention_plain(q, k, v, kv_valid=kv_valid), *FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_attention_fwd_reads_the_encoder_projections_in_place(dev, gen, dtype):
    """q, k, v as the (B, H, T, 64) views of (B, T, H*64) projections, the
    output as a view of a (B, T, H, 64) buffer."""
    b, t, h = 2, 150, 4
    q, k, v = (_randn(gen, b, t, h * 64, dtype=dtype).view(b, t, h, 64).transpose(1, 2)
               for _ in range(3))
    got = flash_fwd.full_attention_fwd(q, k, v, scale=0.125)
    assert got.transpose(1, 2).is_contiguous()
    _close(got, flash_fwd.full_attention_plain(q, k, v, scale=0.125), *FWD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 200, 1500])
@pytest.mark.parametrize("hq,g", [(4, 4), (8, 2)])
def test_causal_attention_fwd(dev, gen, dtype, t, hq, g):
    q = _randn(gen, 2, hq, t, 64, dtype=dtype)
    k, v = (_randn(gen, 2, g, t, 64, dtype=dtype) for _ in range(2))
    before = flash_fwd.FLASH_CAUSAL.launches
    got = flash_fwd.causal_attention_fwd(q, k, v)
    assert flash_fwd.FLASH_CAUSAL.launches == before + 1
    _close(got, flash_fwd.causal_attention_fwd_plain(q, k, v), *FWD_TOL[dtype])


def test_full_attention_fwd_at_the_relprompt_shape_repeats_bitwise(dev, gen):
    """K6 at fp32 at the RelPrompt slice's shape (B1 H20 T=S=280): two calls
    give the same bits (the pieces' products sum in a fixed order), and each
    call counts one launch (its split pre-pass and attention kernel)."""
    q, k, v = (_randn(gen, 1, 20, 280, 64, dtype=torch.float32) for _ in range(3))
    before = flash_fwd.FLASH_FULL.launches
    first, second = flash_fwd.full_attention_fwd(q, k, v), flash_fwd.full_attention_fwd(q, k, v)
    assert flash_fwd.FLASH_FULL.launches == before + 2
    assert torch.equal(first, second)
    _close(first, flash_fwd.full_attention_plain(q, k, v), *FWD_TOL[torch.float32])


def _tf32(x):
    """x with the 13 low mantissa bits cleared: the operand of a TF32 product."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _two_bf16(x):
    """x as two bf16 pieces (16 mantissa bits): the operand of a two-piece
    split product."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("causal", [False, True])
def test_fp32_attention_keeps_fp32_accuracy_at_large_logits(dev, gen, causal):
    """K6 and K7 at fp32 on logits up to ~130 (q * scale of std 3): the
    kernel's three bf16 pieces of each operand keep FWD_TOL[fp32]; the same
    arithmetic on operands cut to TF32, or to two bf16 pieces, misses it
    (each emulated by the plain version on the cut operands)."""
    q = _randn(gen, 1, 20, 280, 64, dtype=torch.float32, std=24.0)
    k, v = (_randn(gen, 1, 20, 280, 64, dtype=torch.float32) for _ in range(2))
    fwd, plain = ((flash_fwd.causal_attention_fwd, flash_fwd.causal_attention_fwd_plain)
                  if causal else (flash_fwd.full_attention_fwd, flash_fwd.full_attention_plain))
    want = plain(q, k, v)
    _close(fwd(q, k, v), want, *FWD_TOL[torch.float32])
    atol = FWD_TOL[torch.float32][0]
    for cut in (_tf32, _two_bf16):
        emulated = plain(cut(q * 0.125), cut(k), cut(v), scale=1.0)
        assert float((emulated - want).abs().max()) > atol, cut.__name__


def test_flash_fwd_refuses_what_it_does_not_take(dev, gen):
    x = _randn(gen, 1, 2, 8, 32, dtype=torch.float32)
    with pytest.raises(ValueError, match="head size"):
        flash_fwd.full_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="head size"):
        flash_fwd.causal_attention_fwd(x, x, x)
    x = _randn(gen, 1, 2, 8, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        flash_fwd.full_attention_fwd(x, x, x)
    q = _randn(gen, 1, 2, 8, 64, dtype=torch.float32)
    k = _randn(gen, 1, 2, 9, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="causal"):
        flash_fwd.causal_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="aligned"):
        odd = _randn(gen, 1, 2, 8, 65, dtype=torch.float32)[..., :64]
        flash_fwd.full_attention_fwd(odd, odd, odd)


def test_flash_fwd_runs_the_plain_version_on_a_cpu_tensor(dev, gen):
    q, k, v = (_randn(gen, 1, 2, 70, 64, dtype=torch.float32).cpu() for _ in range(3))
    before = (flash_fwd.FLASH_FULL.launches, flash_fwd.FLASH_CAUSAL.launches)
    assert torch.equal(flash_fwd.full_attention_fwd(q, k, v),
                       flash_fwd.full_attention_plain(q, k, v))
    assert torch.equal(flash_fwd.causal_attention_fwd(q, k, v),
                       flash_fwd.causal_attention_fwd_plain(q, k, v))
    assert (flash_fwd.FLASH_FULL.launches, flash_fwd.FLASH_CAUSAL.launches) == before


def test_launch_counts(dev, gen):
    x = _randn(gen, 4, 64)
    before = rmsnorm.RMS_NORM.launches
    rmsnorm.rms_norm(x, torch.ones(64, device=dev))
    rmsnorm.rms_norm_plain(x, torch.ones(64, device=dev))
    assert rmsnorm.RMS_NORM.launches == before + 1


def test_small_model_on_the_card_matches_the_cpu(dev):
    """A 2-layer model with head size 64 and LoRA: prefill and one decode
    step, card bf16 against CPU fp32. Tolerance: 0.15 of the logits' spread
    (a wiring fault moves them by about the spread, bf16 rounding by ~5%)."""
    cfg = GPTConfig(name="small", block_size=128, vocab_size=256, padding_multiple=64,
                    n_layer=2, n_head=8, n_query_groups=2, n_embd=512,
                    rotary_percentage=1.0, parallel_residual=False, bias=False,
                    norm_class="RMSNorm", mlp_class="LLaMAMLP", intermediate_size=640,
                    lora_r=4, lora_alpha=8, lora_query=True, lora_key=True,
                    lora_value=True, lora_projection=True, lora_start_layer=1)
    cpu = GPT(cfg, device="cpu", dtype=torch.float32)
    cpu.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for block in cpu.blocks:
            for mod in (block.attn.qkv, block.attn.proj):
                mod.lora_B.normal_(0.0, 0.2)
    card = GPT(cfg, device=dev, dtype=torch.bfloat16)
    card.load_state_dict(cpu.state_dict())

    ids = torch.randint(3, 250, (3, 70), generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([70, 41, 9])
    cache_cpu, cache_card = cpu.init_cache(3, 80), card.init_cache(3, 80)
    want = cpu.prefill(ids, lengths, cache_cpu)
    got = card.prefill(ids.to(dev), lengths.to(dev), cache_card).cpu()
    tol = 0.15 * float(want.std())
    assert float((got - want).abs().max()) < tol
    tok = want.argmax(-1)
    want = cpu.decode_step(tok, lengths, cache_cpu)
    got = card.decode_step(tok.to(dev), lengths.to(dev), cache_card).cpu()
    assert float((got - want).abs().max()) < tol


def _close_bwd(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    want = want.float()
    diff = (got.float() - want).abs()
    bound = (2.0 ** -10 + 2.0 ** -4 * float(want.pow(2).mean().sqrt())
             + 2.0 ** -6 * want.abs())
    assert bool((diff <= bound).all()), f"max abs err {float(diff.max())}"


def _flash_inputs(gen, b, hq, g, t, d=64):
    q = _randn(gen, b, hq, t, d)
    k = _randn(gen, b, g, t, d)
    v = _randn(gen, b, g, t, d)
    o, lse = attention._flash_fwd(q, k, v, d ** -0.5)
    return q, k, v, o, lse


# K1's backward: T on both sides of its 64-row query tiles and 64- or
# 128-key blocks
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 200, 256, 1024])
@pytest.mark.parametrize("hq,g", [(4, 4), (16, 2)])
def test_flash_attention_bwd(dev, gen, t, hq, g):
    """q_per_kv 1 and 8; O as the forward's (B, T, H, D) view."""
    q, k, v, o, lse = _flash_inputs(gen, 2, hq, g, t)
    assert o.stride()[1] == 64  # heads adjacent: the (B, T, H, D) buffer
    do = _randn(gen, 2, hq, t, 64)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    for x, y in zip(got, want):
        _close_bwd(x, y)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 200, 256, 1024])
@pytest.mark.parametrize("hq,g", [(4, 4), (16, 4)])
def test_flash_attention_bwd_head_size_128(dev, gen, t, hq, g):
    """K1's backward at Mixtral's head size (q_per_kv 1 and 4, Mixtral's)."""
    scale = 128 ** -0.5
    q, k, v, o, lse = _flash_inputs(gen, 2, hq, g, t, d=128)
    do = _randn(gen, 2, hq, t, 128)
    before = attention.FLASH_BWD.launches
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    assert attention.FLASH_BWD.launches == before + 1
    want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    for x, y in zip(got, want):
        _close_bwd(x, y)


def test_flash_attention_bwd_takes_strided_grad(dev, gen):
    q, k, v, o, lse = _flash_inputs(gen, 2, 8, 2, 130)
    do = _randn(gen, 2, 130, 8, 128)[..., :64].transpose(1, 2)  # (B, H, T, D) view
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, 0.125)
    want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    for x, y in zip(got, want):
        _close_bwd(x, y)


def test_flash_attention_bwd_refuses_what_it_does_not_take(dev, gen):
    q, k, v, o, lse = _flash_inputs(gen, 1, 4, 2, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.flash_attention_bwd(q, k, v, o, lse, o.float(), 0.125)
    with pytest.raises(TypeError, match="fp32 lse"):
        attention.flash_attention_bwd(q, k, v, o, lse.bfloat16(), o, 0.125)
    small = [_randn(gen, 1, h, 16, 48) for h in (4, 2, 2, 4, 4)]
    with pytest.raises(ValueError, match="head size"):
        attention.flash_attention_bwd(*small[:4], lse, small[4], 0.125)


def test_autograd_ops_on_the_card_match_the_plain_pair(dev, gen):
    """causal_attention, apply_rope, rms_norm and swiglu_mlp with grad: the
    kernels forward and backward against the same ops on CPU copies (plain
    versions), in bf16; rope's transposed launches are counted apart."""
    from dualhyp_tpu_torch.ops import rope as rope_ops

    def leaf(x):
        return x.detach().requires_grad_()

    qkv = _randn(gen, 2, 70, 8 * 64 + 2 * 2 * 64, std=0.5)
    cfg = GPTConfig(n_embd=512, n_head=8, n_query_groups=2, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    cos, sin = rope.build_rope_cache(70, 64, dtype=torch.bfloat16, device=dev)
    scale = 1.0 + _randn(gen, 512, dtype=torch.float32, std=0.1)
    w1, w2 = (_randn(gen, 256, 512, std=0.05) for _ in range(2))
    w3 = _randn(gen, 512, 256, std=0.05)
    grads = {}
    for where in ("cuda", "cpu"):
        x = leaf(qkv.to(where))
        ws = [leaf(w.to(where)) for w in (w1, w2, w3)]
        s = leaf(scale.to(where))
        q5, k, v = split_heads(cfg, x)
        c, sn = cos.to(where), sin.to(where)
        q = rope.apply_rope(q5, c, sn).reshape(2, 8, 70, 64)
        y = attention.causal_attention(q, rope.apply_rope(k, c, sn), v)
        h = rmsnorm.rms_norm(y.transpose(1, 2).reshape(2, 70, 512), s)
        out = swiglu.swiglu_mlp(h, *ws)
        before = rope_ops.ROPE_T.launches
        out.float().square().mean().backward()
        if where == "cuda":
            assert rope_ops.ROPE_T.launches == before + 2
        grads[where] = [t.grad.float().cpu() for t in (x, s, *ws)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got - want).norm() / want.norm()) < 0.05


# K8 and K5 round once to bf16 from fp32 sums taken in another order than the
# plain version's: one or two bf16 ulps (rtol 2^-6), atol for outputs near 0
Q4_TOL = (2e-3, 2.0 ** -6)


# rows on both sides of the decode tile (16) and of the wgmma kernel's
# 128-token tile, and a part-filled token tile (64, 65); N not a multiple
# of its 128 weight rows; K of one group and of five (the ring holds three)
@pytest.mark.parametrize("rows", [1, 8, 16, 17, 64, 65, 127, 128, 129, 3072])
@pytest.mark.parametrize("n", [100, 320])
@pytest.mark.parametrize("k", [640, 128])
def test_q4_matmul(dev, gen, rows, n, k):
    w = _randn(gen, n, k, dtype=torch.float32, std=0.05)
    packed, scales = quant.quantize_weight_int4(w)
    x = _randn(gen, rows, k)
    before = int4.Q4_MATMUL.launches
    got = int4.q4_matmul(x, packed, scales)
    assert int4.Q4_MATMUL.launches == before + 1
    _close(got, int4.q4_matmul_plain(x, packed, scales), *Q4_TOL)


def test_q4_matmul_splits_k_and_reads_strided_rows(dev, gen):
    w = _randn(gen, 256, 2048, dtype=torch.float32, std=0.05)
    packed, scales = quant.quantize_weight_int4(w)
    assert int4.decode_plan(8, 256, 2048)["cluster"] > 1
    x = _randn(gen, 8, 4096)[:, 1024:3072]  # a row stride of 4096 elements
    _close(int4.q4_matmul(x, packed, scales), int4.q4_matmul_plain(x, packed, scales),
           *Q4_TOL)


# TinyLlama-1.1B's int4 linears at decode (N, K): qkv, attn.proj, fc_1 (and
# fc_2), mlp.proj, lm_head; K5's fused QKV (rank 3 x 16) and proj (16)
Q4_DECODE_SHAPES = {"qkv": (2560, 2048), "attn_proj": (2048, 2048), "fc_1": (5632, 2048),
                    "mlp_proj": (2048, 5632), "lm_head": (32000, 2048)}
LORA_DECODE_SHAPES = {"qkv": (2560, 2048, 48), "proj": (2048, 2048, 16)}
_decode_weights = {}


def _q4_weights(gen, name):
    """The packed weights and scales of a slice shape, made once a run."""
    if name not in _decode_weights:
        n, k = Q4_DECODE_SHAPES[name]
        _decode_weights[name] = quant.quantize_weight_int4(
            _randn(gen, n, k, dtype=torch.float32, std=0.02))
    return _decode_weights[name]


@pytest.mark.parametrize("name", list(Q4_DECODE_SHAPES))
@pytest.mark.parametrize("rows", list(range(1, 17)))
def test_q4_matmul_decode_rows_at_the_slice_shapes(dev, gen, name, rows):
    packed, scales = _q4_weights(gen, name)
    x = _randn(gen, rows, Q4_DECODE_SHAPES[name][1])
    before = int4.Q4_MATMUL.launches
    got = int4.q4_matmul(x, packed, scales)
    assert int4.Q4_MATMUL.launches == before + 1
    _close(got, int4.q4_matmul_plain(x, packed, scales), *Q4_TOL)


@pytest.mark.parametrize("name", list(LORA_DECODE_SHAPES))
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("s", [0.0, 0.75, 2.0])
@pytest.mark.parametrize("separate", [False, True])
def test_lora_linear_decode_rows_at_the_slice_shapes(dev, gen, name, rows, s, separate):
    o, d, r = LORA_DECODE_SHAPES[name]
    x = _randn(gen, rows, d)
    xin = _randn(gen, rows, d) if separate else None
    w, a = _randn(gen, o, d, std=0.02), _randn(gen, r, d, std=d ** -0.5)
    b = _randn(gen, o, r, std=0.02)
    before = lora.LORA_LINEAR.launches
    got = lora.lora_linear(x, w, a, b, s, xin=xin)
    assert lora.LORA_LINEAR.launches == before + 1
    _close(got, lora.lora_linear_plain(x, w, a, b, s, xin), *Q4_TOL)


@pytest.mark.parametrize("rows", [17, 24, 32])
@pytest.mark.parametrize("separate", [False, True])
def test_lora_linear_decode_kernel_takes_up_to_32_rows(dev, gen, rows, separate):
    """The decode kernel's three- and four-token-tile instances (17 to 32
    rows, lora.DECODE_ROWS)."""
    assert lora.DECODE_ROWS == 32
    o, d, r = LORA_DECODE_SHAPES["qkv"]
    x = _randn(gen, rows, d)
    xin = _randn(gen, rows, d) if separate else None
    w, a = _randn(gen, o, d, std=0.02), _randn(gen, r, d, std=d ** -0.5)
    b = _randn(gen, o, r, std=0.02)
    _close(lora.lora_linear(x, w, a, b, 0.75, xin=xin),
           lora.lora_linear_plain(x, w, a, b, 0.75, xin), *Q4_TOL)


def _decode_call(gen, kernel):
    """(wrapper, call) of K8 at fc_1 on a strided x (read in place) or K5
    at the fused QKV with a separate xin, at 8 rows; or L2's forward at 16
    rows (8 tokens x top 2) over 8 experts at a long K, which its plan
    splits over a cluster."""
    if kernel == "grouped_matmul":
        lhs, w = _randn(gen, 16, 14336), _randn(gen, 8, 256, 14336, std=0.02)
        sizes = torch.tensor([5, 0, 3, 2, 0, 4, 0, 2], dtype=torch.int32, device=lhs.device)
        assert gmm.decode_plan(16, 256, 14336, 8)["cluster"] > 1
        return gmm.GROUPED_MATMUL, lambda: gmm.grouped_matmul(lhs, w, sizes)
    if kernel == "q4_matmul":
        packed, scales = _q4_weights(gen, "fc_1")
        x = _randn(gen, 8, 4096)[:, 1024:3072]  # a row stride of 4096 elements
        return int4.Q4_MATMUL, lambda: int4.q4_matmul(x, packed, scales)
    x, xin = _randn(gen, 8, 2048), _randn(gen, 8, 2048)
    w, a = _randn(gen, 2560, 2048, std=0.02), _randn(gen, 48, 2048, std=0.02)
    b = _randn(gen, 2560, 48, std=0.02)
    return lora.LORA_LINEAR, lambda: lora.lora_linear(x, w, a, b, 1.0, xin=xin)


@pytest.mark.parametrize("kernel", ["q4_matmul", "lora_linear", "grouped_matmul"])
def test_decode_kernels_repeat_bitwise(dev, gen, kernel):
    """K8 and K5 at 8 rows and L2 at 16 add their K split in a fixed order
    (no atomics): two calls give the same bits, one launch each."""
    wrapper, call = _decode_call(gen, kernel)
    before = wrapper.launches
    first, second = call(), call()
    assert wrapper.launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("kernel", ["q4_matmul", "lora_linear", "grouped_matmul"])
def test_decode_kernels_run_one_cuda_kernel_without_a_host_sync(dev, gen, kernel):
    """At decode rows a call is one CUDA kernel (K8: no second pass over
    split parts; no copy of the strided x; L2: no group size read back)
    and never waits for the card."""
    from torch.profiler import ProfilerActivity, profile

    _, call = _decode_call(gen, kernel)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
    assert len(names) == 1, names


def test_q4_matmul_refuses_what_it_does_not_take(dev, gen):
    packed, scales = quant.quantize_weight_int4(_randn(gen, 64, 256, dtype=torch.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        int4.q4_matmul(_randn(gen, 4, 256, dtype=torch.float32), packed, scales)
    with pytest.raises(ValueError, match="group"):
        int4.q4_matmul(_randn(gen, 4, 256), packed, scales, group=64)


@pytest.mark.parametrize("rows,o,d", [(1, 100, 64), (8, 2560, 256), (37, 130, 264),
                                      (300, 200, 512)])
@pytest.mark.parametrize("r", [16, 48])
@pytest.mark.parametrize("s", [2.0, 0.0])
@pytest.mark.parametrize("separate", [False, True])
def test_lora_linear(dev, gen, rows, o, d, r, s, separate):
    x = _randn(gen, rows, d)
    xin = _randn(gen, rows, d) if separate else None
    w = _randn(gen, o, d, std=0.05)
    a = _randn(gen, r, d, std=0.05)
    b = _randn(gen, o, r, std=0.05)
    got = lora.lora_linear(x, w, a, b, s, xin=xin)
    _close(got, lora.lora_linear_plain(x, w, a, b, s, xin), *Q4_TOL)


# K5's wgmma kernels (rows above lora.DECODE_ROWS, 32): rows around the rank
# kernel's 64-row and the base kernel's 128-row tiles and the fused slice's
# prefill (1536), ranks that are not multiples of 16 (8, 40) or of 8 (4:
# the wrapper pads A and B with zeros) and the largest (64), O past two
# 256-column tiles, D of eleven 64-deep stages, and s = 0.75 (folded into
# the base sum: not a power of two, so one more fp32 rounding of each term)
@pytest.mark.parametrize("rows", [33, 64, 127, 128, 129, 1536])
@pytest.mark.parametrize("r", [4, 8, 40, 64])
@pytest.mark.parametrize("separate", [False, True])
def test_lora_linear_wgmma_tiles(dev, gen, rows, r, separate):
    x = _randn(gen, rows, 704)
    xin = _randn(gen, rows, 704) if separate else None
    w = _randn(gen, 520, 704, std=0.05)
    a = _randn(gen, r, 704, std=0.05)
    b = _randn(gen, 520, r, std=0.05)
    before = lora.LORA_LINEAR.launches
    got = lora.lora_linear(x, w, a, b, 0.75, xin=xin)
    assert lora.LORA_LINEAR.launches == before + 1
    _close(got, lora.lora_linear_plain(x, w, a, b, 0.75, xin), *Q4_TOL)


def test_lora_linear_takes_an_unaligned_batched_input(dev, gen):
    """x of shape (B, T, d) starting 2 bytes past a 16-byte boundary (TMA
    needs aligned rows: the wrapper copies it)."""
    flat = _randn(gen, 1 + 2 * 40 * 256)
    x = flat[1:].view(2, 40, 256)
    assert x.data_ptr() % 16
    w, a, b = _randn(gen, 96, 256, std=0.05), _randn(gen, 16, 256, std=0.05), _randn(
        gen, 96, 16, std=0.05)
    got = lora.lora_linear(x, w, a, b, 2.0)
    assert got.shape == (2, 40, 96)
    _close(got, lora.lora_linear_plain(x, w, a, b, 2.0), *Q4_TOL)


def test_lora_linear_autograd_on_the_card_matches_the_cpu(dev, gen):
    x, xin = _randn(gen, 70, 256), _randn(gen, 70, 256)
    w = _randn(gen, 96, 256, std=0.05)
    a = _randn(gen, 16, 256, dtype=torch.float32, std=0.05)
    b = _randn(gen, 96, 16, dtype=torch.float32, std=0.05)
    grads = {}
    for where in ("cuda", "cpu"):
        leaves = [t.to(where).detach().requires_grad_() for t in (x, xin, a, b)]
        before = lora.LORA_LINEAR.launches
        out = lora.lora_linear(leaves[0], w.to(where), leaves[2], leaves[3], 2.0,
                               xin=leaves[1])
        out.float().square().mean().backward()
        if where == "cuda":
            assert lora.LORA_LINEAR.launches == before + 1
        grads[where] = [t.grad.float().cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got - want).norm() / want.norm()) < 0.02


@pytest.mark.parametrize("rows", [8, 300])
def test_lora_linear_forward_and_backward_do_not_sync_the_host(dev, gen, rows):
    """K5 and its backward enqueue work without waiting for the card (a
    wait in every backward call left the fused training step host-bound)."""
    x, xin = (_randn(gen, rows, 256).requires_grad_() for _ in range(2))
    w = _randn(gen, 96, 256, std=0.05)
    a, b = (_randn(gen, *shape, dtype=torch.float32, std=0.05).requires_grad_()
            for shape in ((16, 256), (96, 16)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = lora.lora_linear(x, w, a, b, 0.75, xin=xin)
        out.float().square().mean().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(t.grad is not None for t in (x, xin, a, b))


def test_lora_linear_refuses_what_it_does_not_take(dev, gen):
    x = _randn(gen, 4, 64)
    w, b = _randn(gen, 32, 64), _randn(gen, 32, 80)
    with pytest.raises(ValueError, match="rank"):
        lora.lora_linear(x, w, _randn(gen, 80, 64), b, 1.0)
    with pytest.raises(ValueError, match="% 8"):
        lora.lora_linear(_randn(gen, 4, 60), _randn(gen, 32, 60), _randn(gen, 4, 60),
                         _randn(gen, 32, 4), 1.0)


# L2 (grouped matmul): bf16 products summed in fp32 in another order than the
# plain version's, rounded once: one or two bf16 ulps (as K8)
GMM_TOL = (1e-2, 2.0 ** -6)
GMM_GROUPS = {
    # 8 groups over m rows: ragged, with empty groups first, in the middle
    # and last, and groups that straddle the kernel's 16- and 128-row tiles
    "ragged": lambda m: [m // 8] * 7 + [m - 7 * (m // 8)],
    "empty": lambda m: [0, m // 3, 0, 0, m // 5, m - m // 3 - m // 5 - m // 7, m // 7, 0],
    "one": lambda m: [0, 0, 0, m, 0, 0, 0, 0],
    # groups of 127, 128 and 129 rows (the prefill kernel's 128-row tile), a
    # 3-row group between two large ones, the rest in one group and an
    # empty last group (clipped to m)
    "tile_edges": lambda m: _fill(m, (127, 128, 129, 3, 200)) + [0, 0],
}


def _fill(m, wants):
    sizes = []
    for want in wants:
        sizes.append(min(want, m - sum(sizes)))
    return sizes + [m - sum(sizes)]


def _group_sizes(case, m, dev):
    sizes = GMM_GROUPS[case](m)
    assert sum(sizes) == m and min(sizes) >= 0
    return torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("m", [0, 1, 8, 16, 17, 32, 64, 65, 300, 6144])
@pytest.mark.parametrize("case", list(GMM_GROUPS))
@pytest.mark.parametrize("n,k", [(200, 256), (128, 40), (256, 14336)])
def test_grouped_matmul(dev, gen, m, case, n, k):
    """(256, 14336): a long K, which the decode kernel's plan splits over a
    cluster at up to gmm.DECODE_ROWS rows."""
    if k == 14336 and 0 < m <= gmm.DECODE_ROWS:
        assert gmm.decode_plan(m, n, k, 8)["cluster"] > 1
    lhs = _randn(gen, m, k)
    w = _randn(gen, 8, n, k, std=0.05)
    sizes = _group_sizes(case, m, dev)
    before = gmm.GROUPED_MATMUL.launches
    got = gmm.grouped_matmul(lhs, w, sizes)
    assert gmm.GROUPED_MATMUL.launches == before + (1 if m else 0)
    _close(got, gmm.grouped_matmul_plain(lhs, w, sizes), *GMM_TOL)


@pytest.mark.parametrize("m", [1, 8, 16, 32, 64, 65])
def test_grouped_matmul_decode_rows_past_the_last_group(dev, gen, m):
    """Rows past the last group are zero, at the long K the decode kernel
    splits over a cluster (and at 64 and 65 rows, the TMA kernel's)."""
    n, k = 256, 14336
    lhs, w = _randn(gen, m, k), _randn(gen, 8, n, k, std=0.05)
    sizes = torch.tensor([m // 3, 0, m // 4, 0, 0, 0, 0, 0], dtype=torch.int32, device=dev)
    got = gmm.grouped_matmul(lhs, w, sizes)
    assert not bool(got[m // 3 + m // 4:].any())
    _close(got, gmm.grouped_matmul_plain(lhs, w, sizes), *GMM_TOL)


@pytest.mark.parametrize("kernel", ["q4_matmul", "grouped_matmul", "grouped_matmul_dlhs",
                                    "lora_linear"])
def test_prefill_kernels_repeat_bitwise(dev, gen, kernel):
    """K8, L2's forward and lhs gradient and K5 at 3072 rows sum in a fixed
    order (no atomics): two calls give the same bits, one launch each."""
    if kernel == "lora_linear":
        x, xin = _randn(gen, 3072, 2048), _randn(gen, 3072, 2048)
        w, a = _randn(gen, 2560, 2048, std=0.02), _randn(gen, 48, 2048, std=0.02)
        b = _randn(gen, 2560, 48, std=0.02)
        wrapper, call = lora.LORA_LINEAR, lambda: lora.lora_linear(x, w, a, b, 1.0, xin=xin)
    elif kernel == "q4_matmul":
        packed, scales = quant.quantize_weight_int4(
            _randn(gen, 5632, 2048, dtype=torch.float32, std=0.02))
        x = _randn(gen, 3072, 2048)
        wrapper, call = int4.Q4_MATMUL, lambda: int4.q4_matmul(x, packed, scales)
    else:
        w = _randn(gen, 8, 640, 512, std=0.05)
        sizes = _group_sizes("tile_edges", 3072, dev)
        if kernel == "grouped_matmul":
            x = _randn(gen, 3072, 512)
            wrapper, call = gmm.GROUPED_MATMUL, lambda: gmm.grouped_matmul(x, w, sizes)
        else:
            g = _randn(gen, 3072, 640)
            wrapper, call = gmm.GROUPED_MATMUL_DLHS, lambda: gmm.grouped_matmul_dlhs(g, w, sizes)
    before = wrapper.launches
    first, second = call(), call()
    assert wrapper.launches == before + 2
    assert torch.equal(first, second)


def test_grouped_matmul_zeroes_rows_past_the_groups(dev, gen):
    lhs, w = _randn(gen, 300, 64), _randn(gen, 3, 72, 64, std=0.05)
    sizes = torch.tensor([100, 0, 90], dtype=torch.int32, device=dev)
    got = gmm.grouped_matmul(lhs, w, sizes)
    assert not bool(got[190:].any())
    _close(got, gmm.grouped_matmul_plain(lhs, w, sizes), *GMM_TOL)


def test_grouped_matmul_refuses_what_it_does_not_take(dev, gen):
    w = _randn(gen, 2, 32, 64)
    sizes = torch.tensor([3, 1], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        gmm.grouped_matmul(_randn(gen, 4, 64, dtype=torch.float32), w, sizes)
    with pytest.raises(TypeError, match="int32"):
        gmm.grouped_matmul(_randn(gen, 4, 64), w, sizes.long())
    with pytest.raises(ValueError, match="K % 8"):
        gmm.grouped_matmul(_randn(gen, 4, 60), _randn(gen, 2, 32, 60), sizes)
    with pytest.raises(ValueError, match="contiguous"):
        gmm.grouped_matmul(_randn(gen, 4, 64), _randn(gen, 2, 64, 32).transpose(1, 2), sizes)
    # under grad the forward runs; the backward kernels also need N % 8
    out = gmm.grouped_matmul(_randn(gen, 4, 64).requires_grad_(), w, sizes)
    assert out.grad_fn is not None and "GroupedMatmul" in type(out.grad_fn).__name__
    with pytest.raises(ValueError, match="N % 8"):
        gmm.grouped_matmul_dlhs(_randn(gen, 4, 36), _randn(gen, 2, 36, 64), sizes)
    with pytest.raises(ValueError, match="K % 8"):
        gmm.grouped_matmul_drhs(_randn(gen, 4, 32), _randn(gen, 4, 60), sizes)
    with pytest.raises(ValueError, match="contiguous"):
        gmm.grouped_matmul_dlhs(_randn(gen, 4, 32), _randn(gen, 2, 64, 32).transpose(1, 2),
                                sizes)
    with pytest.raises(TypeError, match="bfloat16"):
        gmm.grouped_matmul_drhs(_randn(gen, 4, 32), _randn(gen, 4, 64, dtype=torch.float32),
                                sizes)


def test_grouped_matmul_runs_the_plain_version_on_a_cpu_tensor(dev, gen):
    lhs, w = _randn(gen, 9, 64, dtype=torch.float32).cpu(), _randn(gen, 2, 8, 64).cpu()
    sizes = torch.tensor([4, 5], dtype=torch.int32)
    before = gmm.GROUPED_MATMUL.launches
    assert torch.equal(gmm.grouped_matmul(lhs, w, sizes),
                       gmm.grouped_matmul_plain(lhs, w, sizes))
    assert gmm.GROUPED_MATMUL.launches == before


@pytest.mark.parametrize("t", [1, 63, 64, 200, 384])
def test_flash_attention_head_size_128(dev, gen, t):
    """K1's forward at Mixtral's head size (8 query heads a KV group)."""
    scale = 128 ** -0.5
    q = _randn(gen, 2, 16, t, 128)
    k, v = _randn(gen, 2, 2, t, 128), _randn(gen, 2, 2, t, 128)
    o, lse = attention._flash_fwd(q, k, v, scale)
    want_o, want_lse = attention.causal_attention_plain_lse(q, k, v, scale)
    _close(o, want_o, 1e-2, 2.0 ** -6)
    _close(lse, want_lse, 1e-4, 1e-5)


def test_small_moe_model_on_the_card_matches_the_cpu(dev):
    """A 2-layer MoE model (head size 128, 8 experts, top 2, LoRA): prefill
    with the grouped matmul on the card (bf16) against the CPU (fp32, plain
    versions). A near tie of router logits may send a token to another
    expert under bf16, which moves its output by about the logits' spread:
    so at least 0.9 of the (layer, token) routes must agree, and the rows
    whose routes all agree hold their logits to 0.15 of the spread (bf16
    rounding gives a few percent, a wiring fault about the spread)."""
    cfg = GPTConfig(name="small-moe", block_size=128, vocab_size=256, padding_multiple=64,
                    n_layer=2, n_head=8, n_query_groups=2, n_embd=1024,
                    rotary_percentage=1.0, parallel_residual=False, bias=False,
                    norm_class="RMSNorm", mlp_class="LLaMAMoE", intermediate_size=512,
                    n_expert=8, n_expert_per_token=2, rope_base=1000000, lora_r=4,
                    lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
                    lora_projection=True)
    cpu = GPT(cfg, device="cpu", dtype=torch.float32, moe_impl="megablox")
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = GPT(cfg, device=dev, dtype=torch.bfloat16, moe_impl="megablox")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()})
    ids = torch.randint(3, 256, (6, 20), generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([20, 12, 8, 5, 3, 2])
    before = gmm.GROUPED_MATMUL.launches
    got, got_routes = prefill_with_routes(torch, card, ids.to(dev), lengths.to(dev))
    assert gmm.GROUPED_MATMUL.launches == before + 3 * cfg.n_layer
    want, want_routes = prefill_with_routes(torch, cpu, ids, lengths)
    valid = torch.arange(20)[None, :] < lengths[:, None]
    agree = (got_routes.cpu() == want_routes).all(-1) | ~valid  # (L, B, T)
    assert float(agree[:, valid].float().mean()) >= 0.9
    held = agree.all(0).all(-1)
    assert int(held.sum()) >= 3
    err = (got.cpu() - want)[held].abs().max()
    assert float(err) <= 0.15 * float(want.std())


def test_grouped_matmul_reads_a_strided_or_unaligned_lhs(dev, gen):
    w = _randn(gen, 3, 40, 64, std=0.05)
    sizes = torch.tensor([5, 0, 12], dtype=torch.int32, device=dev)
    flat = _randn(gen, 17 * 64 + 3)
    for lhs in (_randn(gen, 17, 128)[:, 32:96], flat[3:].view(17, 64)):
        _close(gmm.grouped_matmul(lhs, w, sizes), gmm.grouped_matmul_plain(lhs, w, sizes),
               *GMM_TOL)


# L2's gradients: dlhs as the forward (one or two bf16 ulps); drhs sums up to
# M products in fp32 in another order than the plain version's and rounds
# once, so the same tolerance holds (fp32 order moves a sum by ~1e-6 of it)
@pytest.mark.parametrize("m", [0, 1, 16, 17, 64, 65, 300, 6144, 16384])
@pytest.mark.parametrize("case", list(GMM_GROUPS))
@pytest.mark.parametrize("n,k", [(200, 256), (128, 40)])
def test_grouped_matmul_dlhs(dev, gen, m, case, n, k):
    g = _randn(gen, m, n)
    w = _randn(gen, 8, n, k, std=0.05)
    sizes = _group_sizes(case, m, dev)
    before = gmm.GROUPED_MATMUL_DLHS.launches
    got = gmm.grouped_matmul_dlhs(g, w, sizes)
    assert gmm.GROUPED_MATMUL_DLHS.launches == before + (1 if m else 0)
    _close(got, gmm.grouped_matmul_dlhs_plain(g, w, sizes), *GMM_TOL)


@pytest.mark.parametrize("m", [0, 1, 16, 17, 64, 65, 300, 6144, 16384])
@pytest.mark.parametrize("case", list(GMM_GROUPS))
@pytest.mark.parametrize("n,k", [(200, 256), (128, 40)])
def test_grouped_matmul_drhs(dev, gen, m, case, n, k):
    g, lhs = _randn(gen, m, n, std=0.1), _randn(gen, m, k)
    sizes = _group_sizes(case, m, dev)
    before = gmm.GROUPED_MATMUL_DRHS.launches
    got = gmm.grouped_matmul_drhs(g, lhs, sizes)
    assert gmm.GROUPED_MATMUL_DRHS.launches == before + 1
    want = gmm.grouped_matmul_drhs_plain(g, lhs, sizes)
    _close(got, want, *GMM_TOL)
    for e, size in enumerate(sizes.tolist()):
        if not size:
            assert not bool(got[e].any())


# drhs's 64-row steps and 128 x 256 tiles: groups of 63, 64, 65, 127, 128
# and 129 rows, each but the first starting mid-step, empty groups first, in
# the middle and last, and rows past the last group (the sizes sum to less
# than m: those rows belong to no group)
DRHS_GROUPS = {
    "step_edges": ([63, 1, 64, 65, 127, 128, 129, 0], 0),
    "empty_ends": ([0, 63, 0, 65, 64, 0, 129, 0], 0),
    "past_last": ([5, 64, 0, 127, 0, 0, 0, 0], 37),
}


@pytest.mark.parametrize("layout", list(DRHS_GROUPS))
@pytest.mark.parametrize("n,k", [(200, 256), (128, 40), (136, 264)])
def test_grouped_matmul_drhs_at_its_step_edges(dev, gen, layout, n, k):
    sizes, past = DRHS_GROUPS[layout]
    m = sum(sizes) + past
    g, lhs = _randn(gen, m, n, std=0.1), _randn(gen, m, k)
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    got = gmm.grouped_matmul_drhs(g, lhs, group_sizes)
    _close(got, gmm.grouped_matmul_drhs_plain(g, lhs, group_sizes), *GMM_TOL)
    for e, size in enumerate(sizes):
        if not size:
            assert not bool(got[e].any())


def test_grouped_matmul_drhs_repeats_bitwise(dev, gen):
    """drhs at 16384 rows in skewed groups sums in a fixed order (a block
    owns its tile, no atomics): two calls give the same bits, one launch
    each."""
    g, lhs = _randn(gen, 16384, 640, std=0.1), _randn(gen, 16384, 512)
    sizes = torch.tensor([6549, 4967, 2828, 1301, 506, 173, 55, 5], dtype=torch.int32, device=dev)
    before = gmm.GROUPED_MATMUL_DRHS.launches
    first, second = gmm.grouped_matmul_drhs(g, lhs, sizes), gmm.grouped_matmul_drhs(g, lhs, sizes)
    assert gmm.GROUPED_MATMUL_DRHS.launches == before + 2
    assert torch.equal(first, second)
    _close(first, gmm.grouped_matmul_drhs_plain(g, lhs, sizes), *GMM_TOL)


def test_grouped_matmul_backward_reads_strided_grads_and_unaligned_lhs(dev, gen):
    """A grad that is a column slice, an lhs at an odd offset (both copied
    once), and rows past the last group (their gradient is zero)."""
    w = _randn(gen, 3, 40, 64, std=0.05)
    sizes = torch.tensor([5, 0, 10], dtype=torch.int32, device=dev)
    g = _randn(gen, 17, 80)[:, 16:56]
    flat = _randn(gen, 17 * 64 + 3)
    lhs = flat[3:].view(17, 64)
    dlhs = gmm.grouped_matmul_dlhs(g, w, sizes)
    assert not bool(dlhs[15:].any())
    _close(dlhs, gmm.grouped_matmul_dlhs_plain(g, w, sizes), *GMM_TOL)
    _close(gmm.grouped_matmul_drhs(g, lhs, sizes), gmm.grouped_matmul_drhs_plain(g, lhs, sizes),
           *GMM_TOL)


def test_grouped_matmul_autograd_on_the_card_matches_the_cpu(dev, gen):
    """GroupedMatmul forward and backward on the card against CPU copies:
    dlhs only for a frozen stack (drhs never launches), both when the stack
    takes a gradient."""
    lhs, g = _randn(gen, 300, 64), _randn(gen, 300, 72)
    w = _randn(gen, 4, 72, 64, std=0.05)
    sizes = torch.tensor([100, 0, 150, 50], dtype=torch.int32, device=dev)
    for w_grad in (False, True):
        grads = {}
        for where in ("cuda", "cpu"):
            x = lhs.to(where).float().requires_grad_()
            ww = w.to(where).float().requires_grad_(w_grad)
            if where == "cuda":
                x, ww = (t.detach().bfloat16().requires_grad_(t.requires_grad) for t in (x, ww))
                before = (gmm.GROUPED_MATMUL_DLHS.launches, gmm.GROUPED_MATMUL_DRHS.launches)
            gmm.grouped_matmul(x, ww, sizes.to(where)).backward(g.to(where).to(x.dtype))
            if where == "cuda":
                assert gmm.GROUPED_MATMUL_DLHS.launches == before[0] + 1
                assert gmm.GROUPED_MATMUL_DRHS.launches == before[1] + int(w_grad)
            grads[where] = [t.grad.float().cpu() for t in (x, ww) if t.requires_grad]
        for got, want in zip(grads["cuda"], grads["cpu"]):
            assert float((got - want).norm() / want.norm()) < 0.01


# the small-MoE card-vs-CPU step draws its LoRA B factors from a generator of
# this seed (`small_moe_step`; the spread over draws is in PERF.md)
SMALL_MOE_DRAW = 0
# the share of (layer, row, token) routes that must agree (chip_smoke.py's)
ROUTE_AGREEMENT = 0.9


def small_moe_step(dev, draw: int, shape=(2, 40), hold_alike: bool = False) -> dict:
    """One LoRA Trainer step of a 2-layer MoE (head size 128, 8 experts, top
    2, megablox, remat "moe"), card bf16 against CPU fp32, on the same
    weights: the base from seed 0, every LoRA B drawn from a generator of
    seed `draw`, a batch of `shape` (rows, tokens) from seed 1 with the
    first half of each row's labels masked. Returns the share of (layer,
    row, token) routes that agree (read from both models as they train), the
    rows routed alike at every token and layer, the loss's absolute and each
    LoRA gradient's relative L2 error, and the card's launches of L2's dlhs
    and drhs and K1's backward. `hold_alike`: the other rows' labels are
    masked on both sides, as chip_smoke.py's depth-2 Mixtral training check
    does."""
    from dualhyp_tpu_torch.train import TrainConfig, Trainer

    cfg = GPTConfig(name="small-moe-train", block_size=128, vocab_size=256,
                    padding_multiple=64, n_layer=2, n_head=8, n_query_groups=2, n_embd=1024,
                    rotary_percentage=1.0, parallel_residual=False, bias=False,
                    norm_class="RMSNorm", mlp_class="LLaMAMoE", intermediate_size=512,
                    n_expert=8, n_expert_per_token=2, rope_base=1000000, lora_r=4,
                    lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
                    lora_projection=True)
    cpu = GPT(cfg, device="cpu", dtype=torch.float32, moe_impl="megablox")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(draw)
    with torch.no_grad():
        for block in cpu.blocks:
            for mod in (block.attn.qkv, block.attn.proj):
                mod.lora_B.normal_(0.0, 0.2, generator=gen)
    card = GPT(cfg, device=dev, dtype=torch.bfloat16, moe_impl="megablox")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()})
    ids = torch.randint(3, 256, shape, generator=torch.Generator().manual_seed(1))
    trainers = {where: Trainer(cfg, TrainConfig(
        batch_size=shape[0], micro_batch_size=shape[0], compute_dtype=dtype,
        lm_head_chunk_size=0, remat="moe"), model)
        for where, model, dtype in (("cuda", card, "bfloat16"), ("cpu", cpu, "float32"))}
    agree = (mixtral_routes(torch, card, ids.to(dev)).cpu()
             == mixtral_routes(torch, cpu, ids)).all(-1)  # (L, B, T)
    held = agree.all(0).all(-1)  # (B,)
    labels = ids.numpy().copy()
    labels[:, : shape[1] // 2] = -1
    if hold_alike:
        labels[~held.numpy()] = -1
    batch = {"input_ids": ids.numpy(), "labels": labels}
    results = {}
    for where, trainer in trainers.items():
        kernels = {"dlhs": gmm.GROUPED_MATMUL_DLHS, "drhs": gmm.GROUPED_MATMUL_DRHS,
                   "bwd": attention.FLASH_BWD}
        before = {n: k.launches for n, k in kernels.items()}
        loss, _ = trainer.train_step(batch, 100, 10)
        results[where] = (float(loss), {n: p.grad.float().cpu()
                                        for n, p in trainer.trainable.items()},
                          {n: k.launches - before[n] for n, k in kernels.items()})
    (loss_card, g_card, launches), (loss_cpu, g_cpu, _) = results["cuda"], results["cpu"]
    return {"draw": draw, "route_agreement": float(agree.float().mean()),
            "rows_held": int(held.sum()), "hold_alike": hold_alike,
            "loss_abs_err": abs(loss_card - loss_cpu),
            "grad_rel_l2_err": {n: float((g_card[n] - want).norm() / want.norm())
                                for n, want in g_cpu.items()},
            "launches": launches, "n_layer": cfg.n_layer}


def test_small_moe_training_step_on_the_card_matches_the_cpu(dev):
    """One LoRA Trainer step of a 2-layer MoE (head size 128, 8 experts, top
    2, megablox), card bf16 against CPU fp32, on LoRA B factors drawn from a
    generator of its own (SMALL_MOE_DRAW), on the rows routed alike at every
    token and layer of a 16 x 16 batch (the others' labels masked on both
    sides): the loss within 0.05 and each LoRA gradient within 0.1 relative
    L2 (bf16 rounding gives ~1-2%; a wiring fault ~1). A near tie of router
    logits that sends one token elsewhere under bf16 moves the gradients of
    its row by up to ~14% (PERF.md, 100 draws), so those rows are not held;
    at least 0.9 of the routes must agree and a quarter of the rows be held.
    K1's backward at D=128 and L2's dlhs launch, its drhs does not (the
    stacks are frozen)."""
    r = small_moe_step(dev, SMALL_MOE_DRAW, shape=(16, 16), hold_alike=True)
    # fc_1, fc_2 and proj of each layer
    assert r["launches"] == {"dlhs": 3 * r["n_layer"], "drhs": 0, "bwd": r["n_layer"]}
    assert r["route_agreement"] >= ROUTE_AGREEMENT and 4 * r["rows_held"] >= 16
    assert r["loss_abs_err"] < 0.05
    for name, err in r["grad_rel_l2_err"].items():
        assert err < 0.1, name


# ---- L1: splash attention (forward, dQ, dK/dV) ----

def _splash_inputs(gen, b, hq, g, t, d):
    q, do = _randn(gen, b, hq, t, d), _randn(gen, b, hq, t, d)
    k, v = _randn(gen, b, g, t, d), _randn(gen, b, g, t, d)
    return q, k, v, do


def _splash_check_bwd(q, k, v, o, lse, do, scale):
    """L1's dQ and dK/dV kernels against their plain versions, fed the same
    O, lse and di."""
    di = splash.row_dot(o, do)
    want_dq = splash.splash_dq_plain(q, k, v, lse, do, di, scale)
    want_dk, want_dv = splash.splash_dkv_plain(q, k, v, lse, do, di, scale)
    _close_bwd(splash.splash_dq(q, k, v, lse, do, di, scale), want_dq)
    got_dk, got_dv = splash.splash_dkv(q, k, v, lse, do, di, scale)
    _close_bwd(got_dk, want_dk)
    _close_bwd(got_dv, want_dv)


# T on both sides of the 64-row and 64-key tiles of L1's dQ and dK/dV, of
# their 128-row and 128-key blocks, and of the 128 the JAX wrapper aligns to
SPLASH_T = [1, 63, 64, 65, 127, 128, 129, 192, 200, 256, 1024]


@pytest.mark.parametrize("t", SPLASH_T)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [4, 8])
@pytest.mark.parametrize("scaled", ["aligned", "unaligned"])
def test_splash_kernels(dev, gen, t, d, g, scaled):
    """L1's forward (O and lse), dQ and dK/dV against their plain versions:
    q_per_kv 4 and 2, the kernels at scale 1 (as `splash.causal_attention`
    runs them at T % 128 == 0, on a q_hat rounded with the scale) and at the
    softmax scale (as at other T), each at every T."""
    q, k, v, do = _splash_inputs(gen, 2, 16, g, t, d)
    scale = 1.0 if scaled == "aligned" else d ** -0.5
    before = [x.launches for x in (splash.SPLASH_FWD, splash.SPLASH_DQ, splash.SPLASH_DKV)]
    o, lse = splash.splash_fwd(q, k, v, scale)
    want_o, want_lse = splash.splash_fwd_plain(q, k, v, scale)
    _close(o, want_o, *BF16[1:])
    _close(lse, want_lse, 1e-4, 1e-5)
    _splash_check_bwd(q, k, v, o, lse, do, scale)
    after = [x.launches for x in (splash.SPLASH_FWD, splash.SPLASH_DQ, splash.SPLASH_DKV)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.parametrize("t", [65, 1024])
@pytest.mark.parametrize("d", [64, 128])
def test_splash_gradient_kernels_repeat_bitwise(dev, gen, t, d):
    """L1's dQ and dK/dV write each output once with no atomics: two calls
    on the same inputs give bitwise-equal outputs (q_hat and scale 1 at T =
    1024, the raw q and the softmax scale at a ragged T)."""
    q, k, v, do = _splash_inputs(gen, 2, 16, 4, t, d)
    scale = d ** -0.5
    if splash.aligned(t):
        q, scale = q * torch.tensor(scale, dtype=q.dtype), 1.0
    o, lse = splash.splash_fwd(q, k, v, scale)
    args = (q, k, v, lse, do, splash.row_dot(o, do), scale)
    first = [splash.splash_dq(*args), *splash.splash_dkv(*args)]
    second = [splash.splash_dq(*args), *splash.splash_dkv(*args)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_splash_kernels_read_strided_views(dev, gen):
    """q, k, v as views of a fused QKV projection, dO as a (B, T, H, D)
    transpose, O as the forward's (B, T, H, D) view, at a ragged T."""
    cfg = GPTConfig(n_embd=512, n_head=8, n_query_groups=2, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    q5, k, v = split_heads(cfg, _randn(gen, 2, 70, cfg.qkv_out_dim))
    q = q5.reshape(2, 8, 70, 64)
    do = _randn(gen, 2, 70, 8, 64).transpose(1, 2)
    o, lse = splash.splash_fwd(q, k, v, 0.125)
    assert o.stride()[1] == 64
    want_o, want_lse = splash.splash_fwd_plain(q, k, v, 0.125)
    _close(o, want_o, *BF16[1:])
    _close(lse, want_lse, 1e-4, 1e-5)
    _splash_check_bwd(q, k, v, o, lse, do, 0.125)


def test_splash_kernels_refuse_what_they_do_not_take(dev, gen):
    q, k, v, do = _splash_inputs(gen, 1, 4, 2, 16, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        splash.splash_fwd(q.float(), k, v)
    with pytest.raises(ValueError, match="head size"):
        splash.splash_fwd(*(x[..., :48] for x in (q, k, v)))
    o, lse = splash.splash_fwd(q, k, v)
    di = splash.row_dot(o, do)
    with pytest.raises(TypeError, match="fp32 lse"):
        splash.splash_dq(q, k, v, lse.bfloat16(), do, di)
    with pytest.raises(TypeError, match="bfloat16"):
        splash.splash_dkv(q, k, v, lse, do.float(), di)
    with pytest.raises(ValueError, match="lse"):
        splash.splash_dkv(q, k, v, lse[:, :, :8], do, di)
    # dQ reads q as it lies (the forward copies an input TMA cannot read)
    unaligned = torch.empty(1 * 4 * 16 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        splash.splash_dq(unaligned.view(1, 4, 16, 64), k, v, lse, do, di)


def test_splash_fwd_reads_an_unaligned_input_through_a_copy(dev, gen):
    q, k, v, _ = _splash_inputs(gen, 1, 4, 2, 70, 64)
    unaligned = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(q.shape)
    unaligned.copy_(q)
    assert unaligned.data_ptr() % 16
    o, lse = splash.splash_fwd(unaligned, k, v, 0.125)
    want_o, want_lse = splash.splash_fwd_plain(q, k, v, 0.125)
    _close(o, want_o, *BF16[1:])
    _close(lse, want_lse, 1e-4, 1e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_redesigned_kernels_count_one_launch_a_call(dev, gen, d):
    """L1's forward and K1's backward, called twice on the same inputs: each
    call adds one launch; the forward repeats bit for bit, and the
    backward's second call matches its plain version too (its dQ adds run
    in no fixed order)."""
    q, k, v, o, lse = _flash_inputs(gen, 2, 8, 2, 200, d)
    do = _randn(gen, 2, 8, 200, d)
    scale = d ** -0.5
    want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    before = (splash.SPLASH_FWD.launches, attention.FLASH_BWD.launches)
    outs = []
    for n in (1, 2):
        outs.append(splash.splash_fwd(q, k, v, scale))
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
        assert (splash.SPLASH_FWD.launches, attention.FLASH_BWD.launches) == (
            before[0] + n, before[1] + n)
        for x, y in zip(got, want):
            _close_bwd(x, y)
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("t", [128, 70])
def test_splash_autograd_op_on_the_card_matches_the_cpu(dev, gen, monkeypatch, t):
    """`ops.attention.causal_attention` under DUALHYP_ATTN_IMPL=splash with
    grad: the kernels on the card against the plain versions on CPU copies
    of the same bf16 inputs; L1 launches its three kernels and K1 none."""
    monkeypatch.setenv("DUALHYP_ATTN_IMPL", "splash")
    q, k, v, do = _splash_inputs(gen, 2, 8, 2, t, 64)
    kernels = (splash.SPLASH_FWD, splash.SPLASH_DQ, splash.SPLASH_DKV,
               attention.FLASH_FWD, attention.FLASH_BWD)
    results = {}
    for where in ("cuda", "cpu"):
        leaves = [x.to(where).detach().requires_grad_() for x in (q, k, v)]
        before = [x.launches for x in kernels]
        out = attention.causal_attention(*leaves)
        out.backward(do.to(where))
        if where == "cuda":
            assert [x.launches - b for x, b in zip(kernels, before)] == [1, 1, 1, 0, 0]
        results[where] = [out.detach(), *(x.grad for x in leaves)]
    (o, *grads), (want_o, *want_grads) = results["cuda"], results["cpu"]
    _close(o, want_o.to(dev), *BF16[1:])
    for x, y in zip(grads, want_grads):
        _close_bwd(x, y.to(dev))


# ---- K1 and L1 at every head size of the model registry ----

# the head sizes other than 64 and 128 (those are held above): 32
# (pythia-14m), 80 (phi-2), 96 (Phi-3), 100 (open_llama_3b, through a copy
# padded to 104) and 256 (Gemma, pythia-1b: dK/dV split over two blocks)
REGISTRY_HEADS = [32, 80, 96, 100, 256]


def _k1_and_l1_against_plain(q, k, v, do, scale):
    """K1's forward and backward and L1's forward, dQ and dK/dV on the same
    inputs, each against its plain version; one launch a call."""
    counts = [x.launches for x in (attention.FLASH_FWD, attention.FLASH_BWD, splash.SPLASH_FWD,
                                   splash.SPLASH_DQ, splash.SPLASH_DKV)]
    o, lse = attention._flash_fwd(q, k, v, scale)
    want_o, want_lse = attention.causal_attention_plain_lse(q, k, v, scale)
    _close(o, want_o, 1e-2, 2.0 ** -6)
    _close(lse, want_lse, 1e-4, 1e-5)
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    want = attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    for x, y in zip(got, want):
        _close_bwd(x, y)
    so, slse = splash.splash_fwd(q, k, v, scale)
    want_o, want_lse = splash.splash_fwd_plain(q, k, v, scale)
    _close(so, want_o, *BF16[1:])
    _close(slse, want_lse, 1e-4, 1e-5)
    _splash_check_bwd(q, k, v, so, slse, do, scale)
    after = [x.launches for x in (attention.FLASH_FWD, attention.FLASH_BWD, splash.SPLASH_FWD,
                                  splash.SPLASH_DQ, splash.SPLASH_DKV)]
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 1, 1, 1]


# T on both sides of the 64-row and 64-key tiles and a training length;
# MHA, MQA (8 heads of one group, Gemma-2b's), falcon-7b's 71 heads of one
# group (an odd group size for the dK/dV sum) and 7 of one
@pytest.mark.parametrize("d", REGISTRY_HEADS)
@pytest.mark.parametrize("t", [1, 63, 64, 65, 129, 200, 1024])
@pytest.mark.parametrize("hq,g", [(4, 4), (8, 1), (7, 1), (71, 1)])
def test_flash_and_splash_at_every_registry_head_size(dev, gen, d, t, hq, g):
    b = 1 if hq == 71 else 2
    q, k, v, do = _splash_inputs(gen, b, hq, g, t, d)
    _k1_and_l1_against_plain(q, k, v, do, d ** -0.5)


@pytest.mark.parametrize("d", REGISTRY_HEADS)
def test_flash_and_splash_read_fused_qkv_views_at_every_head_size(dev, gen, d):
    """q, k and v as strided views of the fused QKV projection (phi-2's
    layout: 8 heads, 4 groups), dO as a (B, T, H, D) transpose, at a ragged
    T; the forward's O is the (B, T, H, D') view."""
    cfg = GPTConfig(n_embd=8 * d, n_head=8, n_query_groups=4, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    q5, k, v = split_heads(cfg, _randn(gen, 2, 70, cfg.qkv_out_dim))
    q = q5.reshape(2, 8, 70, d)
    do = _randn(gen, 2, 70, 8, d).transpose(1, 2)
    _k1_and_l1_against_plain(q, k, v, do, d ** -0.5)
    got = attention.causal_attention(q, k, v)
    _close(got, attention.causal_attention_plain(q, k, v), 1e-2, 2.0 ** -6)


@pytest.mark.parametrize("d", REGISTRY_HEADS)
def test_flash_autograd_at_every_head_size_matches_the_cpu(dev, gen, d):
    """`causal_attention` with grad (FlashAttention: K1 forward and
    backward) on the card against the plain pair on CPU copies. The
    gradients are held as a pair is (chip_smoke.py's FLASH_PAIR_REL_L2,
    relative L2 2^-6): Delta carries each side's own O, and in the first
    rows that moves single elements of dQ past the elementwise backward
    bound at any head size, depending on the draw (up to 1.28x it at D 128
    and 1.07x at D 256 over three draws; the plain backward fed the card's
    O moves them as far: scripts/torch_flash_pair_check.py), while each
    kernel alone meets it (test_flash_and_splash_at_every_registry_head_size)."""
    q, k, v, do = _splash_inputs(gen, 2, 8, 2, 130, d)
    results = {}
    for where in ("cuda", "cpu"):
        leaves = [x.to(where).detach().requires_grad_() for x in (q, k, v)]
        out = attention.causal_attention(*leaves)
        out.backward(do.to(where))
        results[where] = [out.detach(), *(x.grad for x in leaves)]
    (o, *grads), (want_o, *want_grads) = results["cuda"], results["cpu"]
    _close(o, want_o.to(dev), 1e-2, 2.0 ** -6)
    for x, y in zip(grads, want_grads):
        y = y.to(dev).float()
        assert float((x.float() - y).norm() / y.norm()) <= 2.0 ** -6


# K8's middle kernel: a verify step's rows (slots x 9 up to 144), the
# Whisper beam's 400 and the path's edges (17, MID_ROWS), at TinyLlama's qkv
# and fc_1 and Whisper's q/k/v/out, fc2 and fc1 (no K split: 40 column
# blocks fill the card)
Q4_MID_SHAPES = {"qkv": (2560, 2048), "fc_1": (5632, 2048), "whisper_attn": (1280, 1280),
                 "whisper_fc2": (1280, 5120), "whisper_fc1": (5120, 1280)}


@pytest.mark.parametrize("name", list(Q4_MID_SHAPES))
@pytest.mark.parametrize("rows", sorted({17, 36, 72, 144, 256, 400, int4.MID_ROWS}))
@pytest.mark.parametrize("layout", ["ragged", "strided"])
def test_q4_matmul_middle_rows(dev, gen, name, rows, layout):
    """Against the plain version, two calls bitwise equal (the cluster's
    parts meet in rank order: no atomics), one launch on the path the
    dispatch names; x as a (rows, K) tensor or a view with a row stride
    of K + 64 and an offset of 32 elements, a row count one past it."""
    n, k = Q4_MID_SHAPES[name]
    packed, scales = quant.quantize_weight_int4(_randn(gen, n, k, dtype=torch.float32, std=0.02))
    if layout == "strided":
        rows += 1
        x = _randn(gen, rows, k + 64)[:, 32:32 + k]
    else:
        x = _randn(gen, rows, k)
    path = int4.path_of(rows, n, k)
    before = (int4.Q4_MATMUL.launches, int4.PATH_LAUNCHES[path])
    got = int4.q4_matmul(x, packed, scales)
    assert (int4.Q4_MATMUL.launches, int4.PATH_LAUNCHES[path]) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, int4.q4_matmul(x, packed, scales))
    _close(got, int4.q4_matmul_plain(x, packed, scales), *Q4_TOL)


# K1's backward at 80 and 96 (narrow boxes past 64 columns, two warpgroups
# of 64 keys, their dQ added in shared memory): T about its 128-key blocks
@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("t", [1, 64, 127, 128, 129, 255, 256, 257])
@pytest.mark.parametrize("hq,g", [(4, 4), (16, 2)])
def test_flash_attention_bwd_narrow_boxes(dev, gen, d, t, hq, g):
    """K1's backward against the plain version and L1's dK/dV against its
    own, two calls of each bitwise equal where no reduce-add sums (dK, dV)."""
    scale = d ** -0.5
    q, k, v, do = _splash_inputs(gen, 2, hq, g, t, d)
    o, lse = attention._flash_fwd(q, k, v, scale)
    before = attention.BWD_HEAD_LAUNCHES[d]
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    assert attention.BWD_HEAD_LAUNCHES[d] == before + 1
    again = attention.flash_attention_bwd(q, k, v, o, lse, do, scale)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    for x, y in zip(got, attention.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)):
        _close_bwd(x, y)
    so, slse = splash.splash_fwd(q, k, v, scale)
    di = splash.row_dot(so, do)
    args = (q, k, v, slse, do, di, scale)
    dkv = splash.splash_dkv(*args)
    assert all(torch.equal(x, y) for x, y in zip(dkv, splash.splash_dkv(*args)))
    for x, y in zip(dkv, splash.splash_dkv_plain(*args)):
        _close_bwd(x, y)


# phi-2's linears (out, in): int4 (K8) at decode, verify and prefill rows,
# fused LoRA (K5, rank 16, q/k/v and proj) at decode and prefill rows
PHI2_Q4_SHAPES = {"qkv": (7680, 2560), "attn_proj": (2560, 2560), "fc": (10240, 2560),
                  "mlp_proj": (2560, 10240), "lm_head": (51200, 2560)}
PHI2_LORA_SHAPES = {"qkv": (7680, 2560, 48), "proj": (2560, 2560, 16)}


@pytest.mark.parametrize("name", list(PHI2_Q4_SHAPES))
@pytest.mark.parametrize("rows", [1, 8, 16, 72, 1536])
def test_q4_matmul_at_phi2_shapes(dev, gen, name, rows):
    n, k = PHI2_Q4_SHAPES[name]
    packed, scales = quant.quantize_weight_int4(
        _randn(gen, n, k, dtype=torch.float32, std=0.02))
    x = _randn(gen, rows, k)
    before = int4.Q4_MATMUL.launches
    got = int4.q4_matmul(x, packed, scales)
    assert int4.Q4_MATMUL.launches == before + 1
    _close(got, int4.q4_matmul_plain(x, packed, scales), *Q4_TOL)


@pytest.mark.parametrize("name", list(PHI2_LORA_SHAPES))
@pytest.mark.parametrize("rows", [1, 8, 72, 1536])
def test_lora_linear_at_phi2_shapes(dev, gen, name, rows):
    o, d, r = PHI2_LORA_SHAPES[name]
    x = _randn(gen, rows, d)
    w, a = _randn(gen, o, d, std=0.02), _randn(gen, r, d, std=d ** -0.5)
    b = _randn(gen, o, r, std=0.02)
    before = lora.LORA_LINEAR.launches
    got = lora.lora_linear(x, w, a, b, 1.0)
    assert lora.LORA_LINEAR.launches == before + 1
    _close(got, lora.lora_linear_plain(x, w, a, b, 1.0), *Q4_TOL)


# K5's and K4's middle rows (csrc/mid_matmul.cuh): around each crossing
# (K5 32/33, 144 and MID_ROWS/MID_ROWS + 1; K4 64/65 and MID_ROWS/MID_ROWS + 1)
# at a verify step's shapes and at a ragged O or `inter` (not a multiple of
# the 128-column block, nor of 64)
LORA_MID_SHAPES = {"qkv": (2560, 2048, 48), "proj": (2048, 2048, 16),
                   "mlp_proj": (2048, 5632, 16), "ragged": (200, 264, 40)}


def _without_sync(call):
    """call() under torch's sync debug mode "error": a host sync raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return call()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _device_kernels(call):
    """(call's result, the CUDA kernels it ran) under torch.profiler, without
    a host sync. A call runs one kernel at least: a profile that recorded
    none (as the profiler sometimes does late in a long process) is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = _without_sync(call)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if names:
            break
    return out, names


@pytest.mark.parametrize("name", list(LORA_MID_SHAPES))
@pytest.mark.parametrize("rows", sorted({32, 33, 36, 72, 144, lora.MID_ROWS, lora.MID_ROWS + 1}))
@pytest.mark.parametrize("s,separate", [(0.75, False), (2.0, True), (0.0, False)])
def test_lora_linear_middle_rows(dev, gen, name, rows, s, separate):
    """Against the plain version, two calls bitwise equal (the cluster's
    parts meet in rank order), one launch counted on the path `path_of`
    names, no host sync."""
    o, d, r = LORA_MID_SHAPES[name]
    x = _randn(gen, rows, d)
    xin = _randn(gen, rows, d) if separate else None
    w, a = _randn(gen, o, d, std=0.02), _randn(gen, r, d, std=d ** -0.5)
    b = _randn(gen, o, r, std=0.05)
    path = lora.path_of(rows)
    before = (lora.LORA_LINEAR.launches, lora.PATH_LAUNCHES[path])
    got = lora.lora_linear(x, w, a, b, s, xin=xin)
    assert (lora.LORA_LINEAR.launches, lora.PATH_LAUNCHES[path]) == (before[0] + 1,
                                                                     before[1] + 1)
    assert torch.equal(got, _without_sync(lambda: lora.lora_linear(x, w, a, b, s, xin=xin)))
    _close(got, lora.lora_linear_plain(x, w, a, b, s, xin), *Q4_TOL)


@pytest.mark.parametrize("rows", sorted({64, 65, 72, 100, swiglu.MID_ROWS,
                                         swiglu.MID_ROWS + 1}))
@pytest.mark.parametrize("d,inter", [(2048, 5632), (128, 200), (256, 1000)])
@pytest.mark.parametrize("gate", ["silu", "gelu"])
def test_swiglu_middle_rows(dev, gen, rows, d, inter, gate):
    """As K5's: against the plain version, bitwise repeats, one launch
    counted on its path, no host sync."""
    std = 0.02 if d == 2048 else 0.05
    x = _randn(gen, rows, d)
    w1, w2 = (_randn(gen, inter, d, std=std) for _ in range(2))
    w3 = _randn(gen, d, inter, std=std)
    path = swiglu.path_of(rows)
    before = (swiglu.SWIGLU.launches, swiglu.PATH_LAUNCHES[path])
    got = swiglu.swiglu_mlp(x, w1, w2, w3, gate)
    assert (swiglu.SWIGLU.launches, swiglu.PATH_LAUNCHES[path]) == (before[0] + 1,
                                                                    before[1] + 1)
    assert torch.equal(got, _without_sync(lambda: swiglu.swiglu_mlp(x, w1, w2, w3, gate)))
    _close(got, swiglu.swiglu_mlp_plain(x, w1, w2, w3, gate), 1e-2, 2.0 ** -6)


@pytest.mark.parametrize("rows", [72, 144])
def test_middle_paths_run_their_cuda_kernels_alone(dev, gen, rows):
    """At a verify step's rows K5's middle path is one CUDA kernel a call and
    K4's two (the gate and the down product): no scratch pass, no fp32
    workspace, no `swiglu_sum_splits_kernel`."""
    o, d, r = LORA_MID_SHAPES["qkv"]
    x = _randn(gen, rows, d)
    w, a = _randn(gen, o, d, std=0.02), _randn(gen, r, d, std=d ** -0.5)
    b = _randn(gen, o, r, std=0.05)
    _, kernels = _device_kernels(lambda: lora.lora_linear(x, w, a, b, 2.0))
    assert len(kernels) == 1 and "LoraMid" in kernels[0], kernels
    w1, w2 = (_randn(gen, 5632, d, std=0.02) for _ in range(2))
    w3 = _randn(gen, d, 5632, std=0.02)
    _, kernels = _device_kernels(lambda: swiglu.swiglu_mlp(x, w1, w2, w3))
    assert len(kernels) == 2, kernels
    assert "GateMid" in kernels[0] and "DownMid" in kernels[1], kernels


if __name__ == "__main__":
    # The spread of the small-MoE card-vs-CPU step over LoRA draws, one JSON
    # line a draw, on the card's machine from the repo root:
    #     python -m tests.test_torch_kernels --moe-draws 100
    import argparse
    import json

    # (the test's step: --rows 16 --tokens 16 --hold-alike)
    parser = argparse.ArgumentParser()
    parser.add_argument("--moe-draws", type=int, required=True)
    parser.add_argument("--rows", type=int, default=2)
    parser.add_argument("--tokens", type=int, default=40)
    parser.add_argument("--hold-alike", action="store_true")
    args = parser.parse_args()
    shape = (args.rows, args.tokens)
    for draw in range(args.moe_draws):
        out = small_moe_step(torch.device("cuda"), draw, shape, args.hold_alike)
        if not args.hold_alike and 0 < out["rows_held"] < args.rows:
            # the same draw on the rows routed alike
            held = small_moe_step(torch.device("cuda"), draw, shape, hold_alike=True)
            out["held_grad_rel_l2_err_max"] = max(held["grad_rel_l2_err"].values())
        out["grad_rel_l2_err_max"] = max(out["grad_rel_l2_err"].values())
        print(json.dumps(out), flush=True)
