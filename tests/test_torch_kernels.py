"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge cases the main path's shapes do not reach: ragged sequence lengths and
row counts, partial rotary, the inverse rotation, a ragged intermediate
size, the gelu gate, strided inputs, fp32 where a kernel takes it, and the
wrappers' refusals. Every test needs an NVIDIA card and skips without one.
On the card's machine (no JAX there) run them without the suite's conftest:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tolerances are elementwise |kernel - plain| <= atol + rtol * |plain|: bf16
outputs may round apart by a bf16 ulp or two (rtol 2^-7 or 2^-6), fp32
outputs differ by summation order only.
"""

import pytest
import torch

from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.models.gpt import GPT, split_heads
from dualhyp_tpu_torch.ops import attention, rmsnorm, rope, swiglu

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


@pytest.mark.parametrize("dtype,atol,rtol", [BF16, F32])
@pytest.mark.parametrize("rows,d", [(1, 64), (8, 2048), (300, 256)])
def test_rms_norm(dev, gen, dtype, atol, rtol, rows, d):
    x = _randn(gen, rows, d, dtype=dtype)
    scale = 1.0 + _randn(gen, d, dtype=torch.float32, std=0.1)
    _close(rmsnorm.rms_norm(x, scale), rmsnorm.rms_norm_plain(x, scale), atol, rtol)


def test_rms_norm_strided_input(dev, gen):
    x = _randn(gen, 256, 40).t()  # (40, 256) with a non-unit channel stride
    scale = torch.ones(256, device=dev)
    _close(rmsnorm.rms_norm(x, scale), rmsnorm.rms_norm_plain(x, scale), *BF16[1:])


@pytest.mark.parametrize("dtype,atol,rtol", [BF16, F32])
@pytest.mark.parametrize("n_elem", [64, 32])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_rope_on_fused_qkv_heads(dev, gen, dtype, atol, rtol, n_elem, transpose):
    cfg = GPTConfig(n_embd=512, n_head=8, n_query_groups=2, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    qkv = _randn(gen, 3, 37, cfg.qkv_out_dim, dtype=dtype)
    q5, k4, v4 = split_heads(cfg, qkv)
    cos, sin = rope.build_rope_cache(37, n_elem, dtype=dtype, device=dev)
    for x in (q5, k4, v4.contiguous()):
        got = rope.apply_rope(x, cos, sin, transpose=transpose)
        assert got.is_contiguous()
        _close(got, rope.apply_rope_plain(x, cos, sin, transpose), atol, rtol)


def test_rope_transpose_inverts(dev, gen):
    x = _randn(gen, 2, 4, 16, 64, dtype=torch.float32)
    cos, sin = rope.build_rope_cache(16, 64, dtype=torch.float32, device=dev)
    back = rope.apply_rope(rope.apply_rope(x, cos, sin), cos, sin, transpose=True)
    _close(back, x, 1e-5, 1e-5)


@pytest.mark.parametrize("t", [1, 17, 64, 65, 200])
@pytest.mark.parametrize("hq,g", [(8, 2), (4, 4)])
def test_flash_attention(dev, gen, t, hq, g):
    q = _randn(gen, 2, hq, t, 64)
    k = _randn(gen, 2, g, t, 64)
    v = _randn(gen, 2, g, t, 64)
    o, lse = attention._flash_fwd(q, k, v, 0.125)
    _close(o, attention.causal_attention_plain(q, k, v, 0.125), 1e-2, 2.0 ** -6)
    logits = torch.matmul(q.float().reshape(2, g, hq // g, t, 64),
                          k.float()[:, :, None].transpose(-1, -2)) * 0.125
    causal = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
    want_lse = torch.logsumexp(logits.masked_fill(~causal, float("-inf")), dim=-1)
    _close(lse, want_lse.reshape(2, hq, t), 1e-4, 1e-5)


def test_flash_attention_reads_fused_qkv_views(dev, gen):
    cfg = GPTConfig(n_embd=512, n_head=8, n_query_groups=2, intermediate_size=256,
                    mlp_class="LLaMAMLP")
    qkv = _randn(gen, 2, 70, cfg.qkv_out_dim)
    q5, k, v = split_heads(cfg, qkv)
    q = q5.reshape(2, 8, 70, 64)
    _close(attention.causal_attention(q, k, v),
           attention.causal_attention_plain(q, k, v), 1e-2, 2.0 ** -6)


def test_flash_attention_refuses_what_it_does_not_take(dev, gen):
    with pytest.raises(ValueError, match="head size"):
        attention.causal_attention(*(_randn(gen, 1, 2, 8, 32) for _ in range(3)))
    with pytest.raises(TypeError, match="bfloat16"):
        attention.causal_attention(*(_randn(gen, 1, 2, 8, 64, dtype=torch.float32)
                                     for _ in range(3)))


@pytest.mark.parametrize("rows", [1, 8, 130])
@pytest.mark.parametrize("inter", [256, 200])
@pytest.mark.parametrize("gate", ["silu", "gelu"])
def test_swiglu(dev, gen, rows, inter, gate):
    d = 128
    x = _randn(gen, rows, d)
    w1, w2 = (_randn(gen, inter, d, std=0.05) for _ in range(2))
    w3 = _randn(gen, d, inter, std=0.05)
    _close(swiglu.swiglu_mlp(x, w1, w2, w3, gate),
           swiglu.swiglu_mlp_plain(x, w1, w2, w3, gate), 1e-2, 2.0 ** -6)


def test_swiglu_refuses_unaligned_width(dev, gen):
    x = _randn(gen, 4, 96)
    w = _randn(gen, 64, 96)
    with pytest.raises(ValueError, match="d % 64"):
        swiglu.swiglu_mlp(x, w, w, _randn(gen, 96, 64))


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
