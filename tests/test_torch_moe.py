"""The port's Mixtral-style MoE against the JAX package's, on the CPU.

Tiny configs (`helpers.tiny_llama_config(mlp_class="LLaMAMoE")`), fp32. On
CPU tensors the port runs the grouped matmul's plain version
(`ops.gmm.grouped_matmul_plain`); it is held against megablox `gmm` in
Pallas interpret mode (with `transpose_rhs=True`, the port's weight layout)
and `jax.lax.ragged_dot`, to 1e-5. The MoE layer in each of
DUALHYP_MOE_IMPL's values is held against the JAX `_moe_mlp` under the same
value to 2e-5 (`tests/test_moe.py`'s tolerance), megablox's `gmm` patched
to interpret mode (the JAX package imports it at call time); the whole
model's prefill logits to 1e-4 and its greedy tokens exactly. The JAX
package reads DUALHYP_MOE_IMPL while it traces, so each case gets a config
of its own name: a jitted function traced under one value is not reused
under another.

Also K1's plain forward at Mixtral's head size 128 against the JAX flash
attention (Pallas interpret mode at T=128, the XLA path at T=96), to 1e-5.
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import megablox

from dualhyp_tpu.ckpt.io import save_params
from dualhyp_tpu.cli.inference_ger import run_inference as jax_run_inference
from dualhyp_tpu.data import hypotheses as jhyp
from dualhyp_tpu.data.tokenizer import Tokenizer as JaxTokenizer
from dualhyp_tpu.infer.decode import generate as jax_generate
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.ops.pallas import flash_vjp
from dualhyp_tpu_torch.ckpt.convert import params_from_jax, tree_from_model
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.cli.inference_ger import run_inference
from dualhyp_tpu_torch.data import hypotheses, synthetic
from dualhyp_tpu_torch.data.tokenizer import Tokenizer
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.models.gpt import GPT, check_supported, moe_top_k, quantize_model
from dualhyp_tpu_torch.ops import attention, gmm
from tests import helpers
from tests.test_torch_decode import _write_tokenizer
from tests.test_torch_gpt import LORA, _port_config

IMPLS = ("dense", "sparse", "megablox")
GMM_ATOL = 1e-5
LAYER_ATOL = 2e-5
LOGIT_ATOL = 1e-4


def _moe_cfg(name="tiny-moe-test", n_expert=4, **kw):
    return helpers.tiny_llama_config(name=name, mlp_class="LLaMAMoE", n_expert=n_expert,
                                     n_expert_per_token=2, rope_base=1000000, **kw)


def _jax_params(cfg, seed=0):
    """The JAX init, with non-zero lora_B so that the LoRA branch counts."""
    params = jgpt.init(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    attn = params["blocks"]["attn"]
    for leaf in (attn["qkv"], attn["proj"]):
        if "lora_B" not in leaf:
            continue
        leaf["lora_B"] = jnp.asarray(
            rng.normal(size=leaf["lora_B"].shape).astype(np.float32) * 0.2)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture
def moe_impl(monkeypatch, request):
    """DUALHYP_MOE_IMPL set for the JAX package, megablox's gmm in Pallas
    interpret mode."""
    impl = request.param
    monkeypatch.setattr(megablox, "gmm", functools.partial(megablox.gmm, interpret=True))
    if impl == "dense":
        monkeypatch.delenv("DUALHYP_MOE_IMPL", raising=False)
    else:
        monkeypatch.setenv("DUALHYP_MOE_IMPL", impl)
    return impl


GROUP_SIZES = {
    "ragged": [5, 17, 3, 15],
    "empty_first": [0, 20, 11, 9],
    "empty_middle": [10, 0, 0, 30],
    "empty_last": [12, 8, 20, 0],
    "one_group": [0, 40, 0, 0],
}


@pytest.mark.parametrize("case", GROUP_SIZES)
def test_grouped_matmul_plain_matches_megablox_and_ragged_dot(rng, case):
    sizes = np.asarray(GROUP_SIZES[case], np.int32)
    m, k, n = int(sizes.sum()), 32, 24
    lhs = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(len(sizes), n, k)).astype(np.float32)  # (E, N, K)
    got = gmm.grouped_matmul(torch.from_numpy(lhs), torch.from_numpy(w),
                             torch.from_numpy(sizes)).numpy()
    want_gmm = megablox.gmm(jnp.asarray(lhs), jnp.asarray(w), jnp.asarray(sizes),
                            preferred_element_type=jnp.float32, tiling=(8, k, n),
                            transpose_rhs=True, interpret=True)
    want_ragged = jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(w.transpose(0, 2, 1)),
                                     jnp.asarray(sizes), precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(got, np.asarray(want_gmm), rtol=0, atol=GMM_ATOL)
    np.testing.assert_allclose(got, np.asarray(want_ragged), rtol=0, atol=GMM_ATOL)


def test_grouped_matmul_plain_zeroes_rows_past_the_groups(rng):
    lhs = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
    want = jax.lax.ragged_dot(jnp.asarray(lhs.numpy()), jnp.asarray(w.numpy().transpose(0, 2, 1)),
                              jnp.asarray([3, 4], jnp.int32),
                              precision=jax.lax.Precision.HIGHEST)
    got = gmm.grouped_matmul(lhs, w, torch.tensor([3, 4], dtype=torch.int32))
    assert not got[7:].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GMM_ATOL)


def test_top_k_breaks_ties_like_jax(rng):
    """Duplicated router rows make tied logits: the ids and values equal
    `jax.lax.top_k`'s, the lower expert id first."""
    x = rng.normal(size=(64, 16)).astype(np.float32)
    gate = rng.normal(size=(8, 16)).astype(np.float32)
    gate[3], gate[6], gate[7] = gate[1], gate[2], gate[0]
    router = x @ gate.T
    router[:4] = [[1, 3, 3, 0, 3, 2, 3, 1]] * 4  # a three-way tie at the top
    want_vals, want_ids = jax.lax.top_k(jnp.asarray(router), 2)
    vals, ids = moe_top_k(torch.from_numpy(router), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    assert (ids[:4] == torch.tensor([1, 2])).all()


@pytest.mark.parametrize("moe_impl", IMPLS, indirect=True)
@pytest.mark.parametrize("n_expert", [4, 8])
def test_moe_layer_matches_jax(rng, moe_impl, n_expert):
    cfg = _moe_cfg(name=f"tiny-moe-layer-{moe_impl}-{n_expert}", n_expert=n_expert)
    params = _jax_params(cfg, seed=1)
    leaves = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["mlp"])
    x = rng.normal(size=(2, 9, cfg.n_embd)).astype(np.float32)
    want = jgpt._moe_mlp(cfg, leaves, jnp.asarray(x))
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    layer = model.blocks[0].mlp
    assert model.moe_impl == moe_impl and layer.impl == moe_impl
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_ATOL, atol=LAYER_ATOL)


def _prompts():
    rng = np.random.default_rng(7)
    ids = rng.integers(3, 90, size=(3, 12)).astype(np.int32)
    lengths = np.array([12, 7, 9], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


@pytest.mark.parametrize("moe_impl", IMPLS, indirect=True)
def test_moe_model_prefill_and_greedy_tokens_match_jax(moe_impl):
    cfg = _moe_cfg(name=f"tiny-moe-model-{moe_impl}", n_expert=8, **LORA)
    params = _jax_params(cfg, seed=2)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    ids, lengths = _prompts()

    jcache = jgpt.init_cache(cfg, 3, 20, dtype=jnp.float32)
    want, _ = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths), jcache,
                           compute_dtype=jnp.float32)
    got = model.prefill(torch.from_numpy(ids).long(), torch.from_numpy(lengths).long(),
                        model.init_cache(3, 20))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)

    want_toks, want_lens = jax_generate(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                        max_new_tokens=6, top_k=1,
                                        compute_dtype=jnp.float32)
    got_toks, got_lens = generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                                  max_new_tokens=6, top_k=1)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))


def test_moe_checkpoint_round_trip(tmp_path):
    """The JAX npz of an MoE model (router (L, E, d), expert stacks (L, E,
    O, I)) loads into the port, and `tree_from_model` gives the same tree."""
    cfg = _moe_cfg(**LORA)
    params = _jax_params(cfg, seed=3)
    save_params(tmp_path / "moe.npz", params)
    model = params_from_jax(load_params(tmp_path / "moe.npz"), _port_config(cfg),
                            device="cpu", dtype=torch.float32)
    tree = tree_from_model(model)
    mlp = tree["blocks"]["mlp"]
    assert mlp["gate"]["weight"].shape == (cfg.n_layer, 4, cfg.n_embd)
    assert mlp["fc_1"]["weight"].shape == (cfg.n_layer, 4, cfg.intermediate_size, cfg.n_embd)
    assert mlp["proj"]["weight"].shape == (cfg.n_layer, 4, cfg.n_embd, cfg.intermediate_size)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)


def test_moe_config_checks(monkeypatch):
    from dualhyp_tpu_torch.registry import config_from_checkpoint

    mixtral = config_from_checkpoint("checkpoints/mistralai/Mixtral-8x7B-Instruct-v0.1",
                                     lora_r=16, lora_alpha=16)
    assert (mixtral.mlp_class, mixtral.n_expert, mixtral.n_expert_per_token) == ("LLaMAMoE", 8, 2)
    assert (mixtral.n_embd, mixtral.head_size, mixtral.n_query_groups) == (4096, 128, 8)
    assert (mixtral.intermediate_size, mixtral.rope_base) == (14336, 1000000)
    check_supported(mixtral)

    cfg = _port_config(_moe_cfg(**LORA))
    model = GPT(cfg, device="cpu", dtype=torch.float32)
    assert model.moe_impl == "dense"
    with pytest.raises(NotImplementedError, match="quantized MoE"):
        quantize_model(model, "int8")
    with pytest.raises(ValueError, match="moe_impl"):
        GPT(cfg, device="cpu", moe_impl="ragged")
    monkeypatch.setenv("DUALHYP_MOE_IMPL", "ragged")
    with pytest.raises(ValueError, match="moe_impl"):
        GPT(cfg, device="cpu")
    monkeypatch.setenv("DUALHYP_MOE_IMPL", "megablox")
    assert GPT(cfg, device="cpu").blocks[1].mlp.impl == "megablox"
    # the expert stacks carry no LoRA, lora_mlp or not: the JAX init gives
    # them none
    moe = GPT(_port_config(_moe_cfg(lora_r=4, lora_mlp=True)), device="cpu").blocks[0].mlp
    assert not any("lora" in name for name, _ in moe.named_parameters())


@pytest.mark.parametrize("moe_impl", ("dense", "sparse"), indirect=True)
def test_moe_run_inference_matches_jax(tmp_path, moe_impl):
    vocab_size = _write_tokenizer(tmp_path)
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=3, n_hyps=5, seed=3))
    cfg = _moe_cfg(name=f"tiny-moe-serve-{moe_impl}", block_size=640, vocab_size=vocab_size,
                   padding_multiple=8, **LORA)
    params = _jax_params(cfg, seed=5)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)

    def dataset(cls, tok):
        return cls("test", str(data), tokenizer=tok, prompts_format="DualHyp", seed=1337)

    jtok, tok = JaxTokenizer(tmp_path), Tokenizer(tmp_path)
    kw = dict(decode_batch=2, max_new_tokens=5, temperature=0.2, top_k=1)
    want_records, want_metrics = jax_run_inference(
        params, cfg, jtok, dataset(jhyp.DualHypothesesDataset, jtok),
        compute_dtype=jnp.float32, **kw)
    got_records, got_metrics = run_inference(
        model, tok, dataset(hypotheses.DualHypothesesDataset, tok), **kw)
    assert got_records == want_records
    assert got_metrics == want_metrics


def test_moe_inference_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    """`main` on an MoE checkpoint directory without base weights: random
    init with a warning, the LoRA leaves of the finetuned npz over it, the
    sparse path through DUALHYP_MOE_IMPL."""
    from dualhyp_tpu_torch.cli import inference_ger

    ckpt = tmp_path / "tiny-moe-cli"
    ckpt.mkdir()
    vocab_size = _write_tokenizer(ckpt)
    cfg = _moe_cfg(block_size=640, vocab_size=vocab_size, padding_multiple=8, **LORA)
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    attn = _jax_params(cfg, seed=1)["blocks"]["attn"]
    save_params(tmp_path / "run" / "best_model.npz",
                {"blocks": {"attn": {m: {k: attn[m][k] for k in ("lora_A", "lora_B")}
                                     for m in ("qkv", "proj")}}})
    data = tmp_path / "test.json"
    synthetic.write_json(data, synthetic.make_records(n_uids=3, seed=4))
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setenv("DUALHYP_MOE_IMPL", "sparse")
    inference_ger.main([
        "--test_path", str(data), "--model_path", str(tmp_path / "run" / "best_model.npz"),
        "--llm_checkpoint", str(ckpt), "--dual_hypotheses", "--prompts_format", "DualHyp",
        "--decode_batch", "2", "--max_new_tokens", "3", "--device", "cpu",
        "--lora_r", "4", "--lora_alpha", "8"])
    rows = json.loads((tmp_path / "run" / "predictions" / "best_model.json").read_text())
    assert len(rows) == 4 and "WER" in rows[-1]
    assert "random init" in capsys.readouterr().out


@pytest.mark.parametrize("t", [128, 96])
def test_causal_attention_plain_at_head_size_128(rng, t):
    """T=128: the Pallas `_fwd_kernel` in interpret mode (O and the row
    logsumexp residual); T=96: the JAX package's XLA path."""
    q = rng.normal(size=(2, 8, t, 128)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, t, 128)).astype(np.float32) for _ in range(2))
    scale = 128 ** -0.5
    want = flash_vjp.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = attention.causal_attention_plain_lse(tq, tk, tv, scale)
    np.testing.assert_allclose(attention.causal_attention_plain(tq, tk, tv, scale).numpy(),
                               np.asarray(want), rtol=0, atol=GMM_ATOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=0, atol=GMM_ATOL)
    if t % 128 == 0:
        _, res = flash_vjp._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
        np.testing.assert_allclose(lse.numpy(), np.asarray(res[4])[..., 0], rtol=0,
                                   atol=GMM_ATOL)
