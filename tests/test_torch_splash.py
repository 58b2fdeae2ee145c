"""L1 (splash attention) of the port against the JAX package's, on the CPU.

On CPU tensors the port runs L1's plain versions (`ops.splash.*_plain`
through `SplashAttention`). The JAX side is
`dualhyp_tpu.ops.pallas.flash_attention.causal_attention`: at T >= 128 with
T % 128 == 0 the splash library kernel in Pallas interpret mode, with its
fused VJP (dq and dkv kernels); at other T its XLA path. Inputs come from
numpy with a seed. Tolerances, each with its reason:

  * fp32: 1e-5 on the output and on every gradient (the same fp32
    arithmetic, sums in another order; ~1e-6 measured);
  * bf16 at aligned T (the same arithmetic: q rounded once with the rounded
    scale, fp32 sums, P times V in fp32, dS and P rounded to bf16 before the
    gradient products): the output within 2 bf16 ulps of each element plus
    the fp32 tolerance (one rounding of a value whose fp32 sums run in
    another order, which near-zero outputs of cancelling terms show at
    ~1e-6), the gradients within 2e-2 (bf16 outputs of fp32 sums of rounded
    terms);
  * bf16 at unaligned T, against the XLA path, which rounds the
    probabilities to bf16 before its PV product where L1 keeps them fp32:
    the output within 2 bf16 ulps of its largest element, the gradients
    within 2e-2 (~1 ulp of the largest measured);
  * a tiny GPT's Trainer step under DUALHYP_ATTN_IMPL=splash against the
    JAX Trainer under the Pallas backend: `tests/test_torch_train.py`'s
    (loss 1e-5 relative, LoRA gradients 1e-4 relative L2); greedy tokens
    exactly, in fp32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.infer.decode import generate as jax_generate
from dualhyp_tpu.ops import attention as jattention
from dualhyp_tpu.ops import backend
from dualhyp_tpu.ops.pallas import flash_attention
from dualhyp_tpu.train import TrainConfig as JaxTrainConfig
from dualhyp_tpu.train import Trainer as JaxTrainer
from dualhyp_tpu_torch.ckpt.convert import flat_from_named, params_from_jax
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.ops import attention, splash
from dualhyp_tpu_torch.train import TrainConfig, Trainer
from tests import helpers
from tests.test_torch_gpt import LORA, _jax_params, _port_config
from tests.test_torch_moe_train import _jax_step_grads
from tests.test_torch_train import TRAIN, _jax_leaf, _rel

FP32_ATOL = 1e-5
BF16_ULPS = 2
BF16_GRAD_ATOL = 2e-2

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, t, d, hq=4, g=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((1, hq, t, d), (1, g, t, d), (1, g, t, d), (1, hq, t, d))]


def _bf16_ulp(x):
    """One bf16 ulp of each element's magnitude (8 significant bits)."""
    x = np.maximum(np.abs(x), np.float32(2.0 ** -120))
    return np.exp2(np.floor(np.log2(x)) - 7)


def _run_both(seed, t, d, dtype, scale):
    """The JAX function's output and VJP, and the port's through
    `splash.causal_attention` with autograd, on the same inputs; all as
    fp32 numpy arrays."""
    jd, td = DTYPES[dtype]
    q, k, v, do = _inputs(seed, t, d)
    out, vjp = jax.vjp(lambda a, b, c: flash_attention.causal_attention(a, b, c, scale),
                       *(jnp.asarray(x, jd) for x in (q, k, v)))
    want = [out, *vjp(jnp.asarray(do, jd))]
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    o = splash.causal_attention(*leaves, scale)
    assert "SplashAttention" in type(o.grad_fn).__name__
    o.backward(torch.from_numpy(do).to(td))
    got = [o, *(x.grad for x in leaves)]
    return ([x.detach().float().numpy() for x in got],
            [np.asarray(jnp.asarray(x, jnp.float32)) for x in want])


def _assert_matches(got, want, dtype, elementwise_ulps):
    (o, *grads), (wo, *wgrads) = got, want
    if dtype == "float32":
        for x, w in zip(got, want):
            np.testing.assert_allclose(x, w, rtol=0, atol=FP32_ATOL)
        return
    if elementwise_ulps:
        tol = BF16_ULPS * _bf16_ulp(wo) + FP32_ATOL
    else:
        tol = BF16_ULPS * _bf16_ulp(np.abs(wo).max())
    assert (np.abs(o - wo) <= tol).all(), np.abs(o - wo).max()
    for x, w in zip(grads, wgrads):
        np.testing.assert_allclose(x, w, rtol=0, atol=BF16_GRAD_ATOL)


@pytest.mark.parametrize("dtype,t,d", [("float32", 128, 64), ("float32", 256, 64),
                                       ("bfloat16", 128, 64), ("bfloat16", 256, 64),
                                       ("bfloat16", 128, 128)])
def test_plain_splash_matches_the_jax_splash_kernel(dtype, t, d):
    """Aligned T: the port's plain forward and gradients against the splash
    kernel (Pallas interpret mode) and its VJP."""
    got, want = _run_both(t + d, t, d, dtype, d ** -0.5)
    _assert_matches(got, want, dtype, elementwise_ulps=True)


def test_aligned_t_rounds_q_and_the_scale_to_the_dtype(monkeypatch):
    """At D=128 in bf16 the scale rounds to 0.08837890625, and the kernels
    get q * that rounded scale (the JAX wrapper's `q * jnp.asarray(scale,
    q.dtype)`, bit for bit) and scale 1."""
    assert float(torch.tensor(128 ** -0.5, dtype=torch.bfloat16)) == 0.08837890625
    q, k, v, _ = _inputs(3, 128, 128)
    seen = {}
    real = splash.SplashAttention.apply

    def spy(qh, kk, vv, scale):
        seen.update(q_hat=qh, scale=scale)
        return real(qh, kk, vv, scale)

    monkeypatch.setattr(splash.SplashAttention, "apply", spy)
    tq = torch.from_numpy(q).to(torch.bfloat16).requires_grad_()
    splash.causal_attention(tq, *(torch.from_numpy(x).to(torch.bfloat16) for x in (k, v)))
    want = jnp.asarray(q, jnp.bfloat16) * jnp.asarray(128 ** -0.5, jnp.bfloat16)
    assert seen["scale"] == 1.0
    np.testing.assert_array_equal(seen["q_hat"].detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # at unaligned T the raw q and the scale go to the kernels
    tq = torch.from_numpy(q[:, :, :96]).to(torch.bfloat16).requires_grad_()
    splash.causal_attention(tq, *(torch.from_numpy(x[:, :, :96]).to(torch.bfloat16)
                                  for x in (k, v)))
    assert seen["scale"] == 1 / math.sqrt(128) and seen["q_hat"] is tq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [96, 200])
def test_unaligned_t_matches_the_jax_xla_path(dtype, t):
    """Unaligned T: the JAX function runs `_causal_attention_xla`; the port
    runs L1 with the scale inside the kernels and the ragged tail masked."""
    got, want = _run_both(t, t, 64, dtype, 0.125)
    _assert_matches(got, want, dtype, elementwise_ulps=False)


@pytest.mark.parametrize("t", [8, 128])
def test_splash_gradcheck_float64(t):
    """The plain dQ and dK/dV against the plain forward's own derivative,
    aligned (q_hat and scale 1) and unaligned (scale in the kernel)."""
    rng = np.random.default_rng(t)
    d = 4 if t == 8 else 2
    args = [torch.from_numpy(rng.normal(size=s)).requires_grad_()
            for s in ((1, 4, t, d), (1, 2, t, d), (1, 2, t, d))]
    assert torch.autograd.gradcheck(lambda *a: splash.causal_attention(*a, 0.5), args,
                                    fast_mode=t > 8)


def _monkey_splash_calls(monkeypatch):
    """Spies on L1 in both packages: ([q shapes of the port's calls], [q
    shapes of the JAX package's splash calls, at trace time])."""
    calls, jax_calls = [], []
    real, real_jax = splash.causal_attention, flash_attention.causal_attention
    monkeypatch.setattr(splash, "causal_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    monkeypatch.setattr(flash_attention, "causal_attention",
                        lambda *a, **kw: jax_calls.append(a[0].shape) or real_jax(*a, **kw))
    return calls, jax_calls


@pytest.mark.parametrize("impl", ["splash", "anything-else"])
def test_attn_impl_other_than_own_goes_to_splash_in_both(monkeypatch, impl):
    """Any value other than "own" runs L1 in the port and splash in the JAX
    package (under its Pallas backend); "own" (the default) runs K1."""
    q, k, v, _ = _inputs(5, 128, 64)
    monkeypatch.setenv("DUALHYP_ATTN_IMPL", impl)
    calls, jax_calls = _monkey_splash_calls(monkeypatch)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = attention.causal_attention(tq, tk, tv)
    with backend.use_backend("pallas"):
        want = jattention.causal_attention(*(jnp.asarray(x) for x in (q, k, v)))
    assert len(calls) == 1 and len(jax_calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_ATOL)
    monkeypatch.delenv("DUALHYP_ATTN_IMPL")
    out = attention.causal_attention(*(x.requires_grad_() for x in (tq, tk, tv)))
    assert len(calls) == 1 and "FlashAttention" in type(out.grad_fn).__name__


def _tiny_cfg():
    return helpers.tiny_llama_config(block_size=160, n_embd=256, n_head=4,
                                     n_query_groups=2, intermediate_size=256, **LORA)


def test_trainer_step_under_splash_matches_jax(monkeypatch):
    """One Trainer step of a 2-layer GPT at T=128 (batch 4 of micro batches
    2) with DUALHYP_ATTN_IMPL=splash in both packages: the JAX Trainer under
    the Pallas backend (splash in interpret mode) against the port's L1
    plain versions."""
    monkeypatch.setenv("DUALHYP_ATTN_IMPL", "splash")
    calls, jax_calls = _monkey_splash_calls(monkeypatch)
    cfg = _tiny_cfg()
    params = _jax_params(cfg, seed=9)
    rng = np.random.default_rng(9)
    ids = rng.integers(1, 90, size=(4, 128)).astype(np.int32)
    labels = ids.copy()
    labels[:, :64] = -1
    batch = {"input_ids": ids, "labels": labels}
    with backend.use_backend("pallas"):
        jax_trainer = JaxTrainer(cfg, JaxTrainConfig(**TRAIN),
                                 jax.tree_util.tree_map(jnp.asarray, params))
        want_grads = _jax_step_grads(jax_trainer, batch)
        want_loss, _ = jax_trainer.train_step(batch, 100, 10, jax.random.key(0))
    port = Trainer(_port_config(cfg), TrainConfig(**TRAIN), params, device="cpu")
    got_loss, _ = port.train_step(batch, 100, 10)
    assert len(calls) == cfg.n_layer * 2  # a forward a layer a micro batch
    assert jax_calls and all(shape[2] == 128 for shape in jax_calls)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    grads = {n: p.grad for n, p in port.trainable.items()}
    for key, g in flat_from_named(grads, cfg.n_layer).items():
        assert _rel(g.numpy(), _jax_leaf(want_grads, key)) <= 1e-4, key


def test_greedy_tokens_under_splash_match_jax(monkeypatch):
    """Greedy decoding of 3 prompts of 128 tokens (the prefill at an aligned
    T runs splash in both packages), fp32: the same tokens."""
    monkeypatch.setenv("DUALHYP_ATTN_IMPL", "splash")
    calls, jax_calls = _monkey_splash_calls(monkeypatch)
    cfg = _tiny_cfg()
    params = _jax_params(cfg, seed=10)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(10)
    ids = rng.integers(3, 90, size=(3, 128)).astype(np.int32)
    lengths = np.array([128, 100, 77], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    with backend.use_backend("pallas"):
        want, want_lens = jax_generate(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                       max_new_tokens=6, top_k=1, compute_dtype=jnp.float32)
    got, got_lens = generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                             max_new_tokens=6, top_k=1)
    assert calls and all(shape[2] == 128 for shape in calls + jax_calls)
    assert jax_calls
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
