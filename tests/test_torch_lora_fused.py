"""The port's fused LoRA linear (K5's plain version) against the JAX
package's Pallas kernel, and the fused-LoRA model against the JAX model run
with DUALHYP_LORA_IMPL=fused.

The Pallas kernel runs in interpret mode on the CPU; everything is fp32.
Tolerances: the forward to 1e-5 and gradients to 1e-4 (fp32 sums in
another order; the gradients pass a few more products), logits to 1e-4 and
LoRA gradients to 1e-4 relative to their largest element through two
layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.ops import backend
from dualhyp_tpu.ops.pallas import lora_kernel
from dualhyp_tpu_torch.ckpt.convert import load_tree, params_from_jax
from dualhyp_tpu_torch.models.gpt import GPT, lora_qkv_shapes
from dualhyp_tpu_torch.ops import lora
from tests import helpers
from tests.test_torch_gpt import CASES, LORA, _jax_params, _port_config

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4

LINEAR_CASES = {
    "basic": dict(gate=1.0, separate=False, qkv=False),
    "gate_0": dict(gate=0.0, separate=False, qkv=False),
    "separate_xin": dict(gate=1.0, separate=True, qkv=False),
    "qkv_block_b": dict(gate=1.0, separate=True, qkv=True),
}


def _linear_inputs(case, rng):
    d, r, scaling = 64, 4, 2.0
    if case["qkv"]:
        shapes = (64, 16, 16)  # [q | k | v] extents of a GQA layer
        o = sum(shapes)
        a = rng.normal(size=(3 * r, d)).astype(np.float32) * 0.2
        b_small = rng.normal(size=(o, r)).astype(np.float32) * 0.2
        b = np.array(lora_kernel.lora_qkv_block_b(jnp.asarray(b_small), shapes, r))
        b_port = lora.lora_qkv_block_b(torch.from_numpy(b_small), shapes, r).numpy()
        np.testing.assert_array_equal(b_port, b)
    else:
        o = 48
        a = rng.normal(size=(r, d)).astype(np.float32) * 0.2
        b = rng.normal(size=(o, r)).astype(np.float32) * 0.2
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    w = rng.normal(size=(o, d)).astype(np.float32) * 0.1
    xin = rng.normal(size=x.shape).astype(np.float32) if case["separate"] else None
    g = rng.normal(size=(2, 5, o)).astype(np.float32)
    return x, xin, w, a, b, scaling, g


@pytest.mark.parametrize("name", LINEAR_CASES)
def test_lora_linear_matches_the_pallas_kernel(name, rng):
    case = LINEAR_CASES[name]
    x, xin, w, a, b, scaling, g = _linear_inputs(case, rng)
    gate = jnp.float32(case["gate"])

    def jax_loss(x_, xin_, a_, b_):
        y = lora_kernel.lora_linear(x_, jnp.asarray(w), a_, b_, scaling, xin=xin_, gate=gate)
        return jnp.sum(y * g), y

    jin = [jnp.asarray(v) for v in (x, xin if xin is not None else x, a, b)]
    if xin is None:
        (_, want), grads = jax.value_and_grad(
            lambda x_, a_, b_: jax_loss(x_, None, a_, b_), argnums=(0, 1, 2),
            has_aux=True)(jin[0], jin[2], jin[3])
        want_grads = [grads[0], grads[1], grads[2]]
    else:
        (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                              has_aux=True)(*jin)
        want_grads = [grads[0], grads[2], grads[3], grads[1]]

    t = {k: torch.from_numpy(v).requires_grad_() for k, v in (("x", x), ("a", a), ("b", b))}
    txin = torch.from_numpy(xin).requires_grad_() if xin is not None else None
    s = scaling * case["gate"]
    with torch.no_grad():
        plain = lora.lora_linear_plain(t["x"], torch.from_numpy(w), t["a"], t["b"], s, txin)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    got = lora.lora_linear(t["x"], torch.from_numpy(w), t["a"], t["b"], s, xin=txin)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=FWD_ATOL)
    ins = [t["x"], t["a"], t["b"]] + ([txin] if txin is not None else [])
    got_grads = torch.autograd.grad(got, ins, torch.from_numpy(g))
    for gg, wg in zip(got_grads, want_grads):
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=0, atol=GRAD_ATOL)


def test_lora_linear_plain_follows_the_kernel_in_bf16(rng):
    """In bf16 the plain version rounds where the Pallas kernel does: the
    rank product once to bf16 before B, the output once; the composition
    also rounds the base product and the delta."""
    x = rng.normal(size=(24, 256)).astype(np.float32)
    xin = rng.normal(size=(24, 256)).astype(np.float32)
    w = rng.normal(size=(96, 256)).astype(np.float32) * 0.05
    a = rng.normal(size=(16, 256)).astype(np.float32) * 0.1
    b = rng.normal(size=(96, 16)).astype(np.float32) * 0.1
    bf = jnp.bfloat16
    want = np.asarray(lora_kernel.lora_linear(
        jnp.asarray(x, bf), jnp.asarray(w, bf), jnp.asarray(a), jnp.asarray(b), 2.0,
        xin=jnp.asarray(xin, bf)), np.float32)
    got = lora.lora_linear_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(a),
        torch.from_numpy(b), 2.0, torch.from_numpy(xin).bfloat16()).float().numpy()
    # fp32 sums in another order: at most one bf16 rounding apart
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)


@pytest.fixture
def fused_env(monkeypatch):
    monkeypatch.setenv("DUALHYP_LORA_IMPL", "fused")
    with backend.use_backend("pallas"):
        yield


@pytest.mark.parametrize("case", ["qkv_proj", "start_layer_1", "q_and_v"])
def test_fused_model_matches_jax_fused(case, fused_env):
    """Forward logits and LoRA gradients of the port's `lora_impl="fused"`
    model against the JAX model with its fused LoRA kernel (the JAX
    package's own switch, under the Pallas backend in interpret mode)."""
    cfg = helpers.tiny_llama_config(**CASES[case])
    params = _jax_params(cfg)
    ids = np.random.default_rng(3).integers(3, 90, size=(2, 12)).astype(np.int32)
    g = np.random.default_rng(4).normal(size=(2, 12, cfg.padded_vocab_size)).astype(np.float32)

    def loss(p):
        logits = jgpt.forward(p, cfg, jnp.asarray(ids), compute_dtype=jnp.float32)
        return jnp.sum(logits * g), logits

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)

    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    assert model.lora_impl == "fused"  # read from DUALHYP_LORA_IMPL
    trainable = model.trainable_parameters()
    for p in trainable.values():
        p.requires_grad_(True)
    got = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    got.backward(torch.from_numpy(g))

    def leaf(tree, name):
        parts = name.split(".")
        stacked = parts[0] == "blocks"
        node = tree["blocks"] if stacked else tree
        for part in parts[2:] if stacked else parts:
            node = node[part]
        return np.asarray(node)[int(parts[1])] if stacked else np.asarray(node)

    for name, p in trainable.items():
        want_g = leaf(grads, name)
        scale = max(np.abs(want_g).max(), 1e-6)
        got_g = p.grad.numpy() if p.grad is not None else np.zeros_like(want_g)
        np.testing.assert_allclose(got_g / scale, want_g / scale, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_fused_and_composition_draw_the_same_dropout_masks():
    """With a generator and dropout, the fused and the composed LoRA linears
    take the same masks (fp32: same values to 1e-5), under remat too."""
    cfg = _port_config(helpers.tiny_llama_config(**LORA, lora_dropout=0.3))
    params = _jax_params(helpers.tiny_llama_config(**LORA, lora_dropout=0.3))
    ids = torch.from_numpy(np.random.default_rng(5).integers(3, 90, size=(2, 10))).long()
    outs = {}
    for impl in ("xla", "fused"):
        model = GPT(cfg, device="cpu", dtype=torch.float32, lora_impl=impl)
        load_tree(model, params)
        for p in model.trainable_parameters().values():
            p.requires_grad_(True)
        y = model(ids, generator=torch.Generator().manual_seed(9), remat=True)
        y.square().mean().backward()
        outs[impl] = (y.detach(), {n: p.grad for n, p in model.trainable_parameters().items()})
    torch.testing.assert_close(outs["fused"][0], outs["xla"][0], rtol=0, atol=1e-5)
    for name, grad in outs["xla"][1].items():
        torch.testing.assert_close(outs["fused"][1][name], grad, rtol=1e-4, atol=1e-7)


def test_fused_lora_is_never_used_on_a_quantized_linear():
    from dualhyp_tpu_torch.models.gpt import merge_lora, quantize_model

    cfg = _port_config(helpers.tiny_llama_config(
        **LORA, n_embd=256, n_head=8, intermediate_size=512, vocab_size=384,
        padding_multiple=128))
    model = GPT(cfg, device="cpu", dtype=torch.float32, lora_impl="fused")
    model.init_weights(torch.Generator().manual_seed(0))
    qkv = model.blocks[0].attn.qkv
    assert qkv.use_fused()
    quantize_model(merge_lora(model), "int8")
    assert qkv.quant == "int8" and not qkv.use_fused()
    assert lora_qkv_shapes(cfg) == qkv.shapes


def test_lora_impl_defaults_to_the_composition(monkeypatch):
    cfg = _port_config(helpers.tiny_llama_config(**LORA))
    monkeypatch.delenv("DUALHYP_LORA_IMPL", raising=False)
    assert GPT(cfg, device="cpu").lora_impl == "xla"
    monkeypatch.setenv("DUALHYP_LORA_IMPL", "fused")
    assert GPT(cfg, device="cpu").lora_impl == "fused"
    assert GPT(cfg, device="cpu", lora_impl="xla").lora_impl == "xla"
    with pytest.raises(ValueError, match="lora_impl"):
        GPT(cfg, device="cpu", lora_impl="triton")
