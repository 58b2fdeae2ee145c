"""The port's quantized decoding against the JAX package's.

Quantizers bit for bit (int8 codes, packed int4 bytes, fp32 scales) on the
same numpy weights; K8's plain version against the Pallas kernel run in
interpret mode (fp32 to 2e-4 as `tests/test_quant.py` holds the kernel, and
bf16 to one bf16 rounding); the int8 product and the KV-cache quantizer
exactly; `merge_lora` to 1e-5; and a tiny fp32 model, quantized by the JAX
package and loaded into the port, under int8 and int4 weights and an int8
KV cache: logits to 1e-4 (fp32 sums in another order) and greedy tokens
exactly. Widths are 256 and 512, the smallest that `quantize_tree`
quantizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.infer.decode import generate as jax_generate
from dualhyp_tpu.models import gpt as jgpt
from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu.ops.pallas import int4_kernel
from dualhyp_tpu_torch.ckpt.convert import params_from_jax, tree_from_model
from dualhyp_tpu_torch.infer.decode import generate
from dualhyp_tpu_torch.models.gpt import merge_lora
from dualhyp_tpu_torch.ops import int4, quant
from tests import helpers
from tests.test_torch_gpt import LORA, _port_config

ATOL = 1e-4

WIDE = dict(n_embd=256, n_head=8, n_query_groups=2, intermediate_size=512,
            vocab_size=384, padding_multiple=128)


def _wide_params(seed, **kw):
    cfg = helpers.tiny_llama_config(**{**WIDE, **LORA, **kw})
    params = jgpt.init(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    attn = params["blocks"]["attn"]
    for leaf in (attn["qkv"], attn["proj"]):
        leaf["lora_B"] = jnp.asarray(
            rng.normal(size=leaf["lora_B"].shape).astype(np.float32) * 0.2)
    if "lora_A" in params["lm_head"]:
        params["lm_head"]["lora_B"] = jnp.asarray(
            rng.normal(size=params["lm_head"]["lora_B"].shape).astype(np.float32) * 0.2)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flat(value, path)
        else:
            yield path, value


def _bits(a):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.uint32)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_tree_gives_the_jax_bytes(mode):
    _, params = _wide_params(0)
    want = dict(_flat(jquant.quantize_tree(params, mode=mode)))
    got = dict(_flat(quant.quantize_tree(params, mode=mode)))
    assert sorted(got) == sorted(want)
    assert any(k.endswith(quant.Q4_KEY if mode == "int4" else quant.Q_KEY) for k in got)
    for key, value in want.items():
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(_bits(got[key]), _bits(value), err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_give_the_jax_bytes_on_one_matrix(dtype, rng):
    w = rng.normal(size=(96, 384)).astype(np.float32) * 0.05
    jw = jnp.asarray(w, dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    for jfn, tfn in ((jquant.quantize_weight, quant.quantize_weight),
                     (jquant.quantize_weight_int4, quant.quantize_weight_int4)):
        jq, js = jfn(jw)
        tq, ts = tfn(tw)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts), _bits(np.asarray(js)))
    jq, js = jquant.quantize_weight_int4(jnp.asarray(w))
    np.testing.assert_array_equal(
        quant.dequantize_weight_int4(torch.from_numpy(np.asarray(jq)),
                                     torch.from_numpy(np.asarray(js))).numpy(),
        np.asarray(jquant.dequantize_weight_int4(jq, js)))


@pytest.mark.parametrize("out_d,in_d", [(320, 640), (256, 2048), (100, 512)])
def test_q4_matmul_plain_matches_the_pallas_kernel(out_d, in_d, rng):
    w = rng.normal(size=(out_d, in_d)).astype(np.float32) * 0.05
    x = rng.normal(size=(5, in_d)).astype(np.float32)
    packed, scale = jquant.quantize_weight_int4(jnp.asarray(w))
    want = np.asarray(int4_kernel.q4_matmul(jnp.asarray(x), packed, scale))
    got = int4.q4_matmul(torch.from_numpy(x), torch.from_numpy(np.asarray(packed)),
                         torch.from_numpy(np.asarray(scale)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_q4_matmul_plain_follows_the_kernel_in_bf16(rng):
    """In bf16 the plain version rounds where the Pallas kernel does (once,
    at the end), not where dequantise-then-matmul does (q * s first)."""
    w = rng.normal(size=(128, 512)).astype(np.float32) * 0.05
    x = rng.normal(size=(6, 512)).astype(np.float32)
    packed, scale = jquant.quantize_weight_int4(jnp.asarray(w))
    want = np.asarray(int4_kernel.q4_matmul(jnp.asarray(x, jnp.bfloat16), packed, scale),
                      np.float32)
    got = int4.q4_matmul_plain(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(np.asarray(packed)),
                               torch.from_numpy(np.asarray(scale))).float().numpy()
    # fp32 sums in another order: at most one bf16 rounding apart
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)


def test_qmatmul_and_q8_rows_are_exact(rng):
    x = rng.normal(size=(3, 7, 256)).astype(np.float32)
    w = rng.normal(size=(64, 256)).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jquant.qmatmul(jnp.asarray(x), jq, js))
    got = quant.qmatmul(torch.from_numpy(x), torch.from_numpy(np.asarray(jq)),
                        torch.from_numpy(np.asarray(js)))
    np.testing.assert_array_equal(got.numpy(), want)
    kv = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    jv, jsc = jquant.q8_rows(jnp.asarray(kv))
    tv, tsc = quant.q8_rows(torch.from_numpy(kv))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("case", [{}, {"lora_start_layer": 1}, {"lora_key": False},
                                  {"lora_head": True}])
def test_merge_lora_matches_jax(case):
    cfg, params = _wide_params(1, **case)
    want = jax.tree_util.tree_map(np.asarray, jgpt.merge_lora(params, cfg))
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    got = dict(_flat(tree_from_model(merge_lora(model))))
    for key, value in _flat(want):
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)


def _prompts(rng):
    ids = rng.integers(3, 380, size=(3, 9)).astype(np.int32)
    lengths = np.array([9, 5, 7], np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids, lengths


@pytest.mark.parametrize("mode,kv_quant", [("int8", None), ("int4", None), (None, "int8"),
                                           ("int4", "int8")])
def test_quantized_decoding_matches_jax(mode, kv_quant, rng):
    """The JAX package merges and quantizes; the port loads its tree (the
    same bytes), and both prefill, take one decode step and decode."""
    cfg, params = _wide_params(2)
    if mode:
        params = jax.tree_util.tree_map(
            np.asarray, jquant.quantize_tree(jgpt.merge_lora(params, cfg), mode=mode))
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    if mode:
        round_trip = dict(_flat(tree_from_model(model)))
        for key, value in _flat(params):
            np.testing.assert_array_equal(_bits(round_trip[key]), _bits(value), err_msg=key)
    ids, lengths = _prompts(rng)
    b, max_seq = ids.shape[0], 16

    jcache = jgpt.init_cache(cfg, b, max_seq, dtype=jnp.float32, quantize=kv_quant)
    want, jcache = jgpt.prefill(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                jcache, compute_dtype=jnp.float32)
    cache = model.init_cache(b, max_seq, quantize=kv_quant)
    got = model.prefill(torch.from_numpy(ids).long(), torch.from_numpy(lengths).long(), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    token = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
    want, jcache = jgpt.decode_step(params, cfg, jnp.asarray(token), jnp.asarray(lengths),
                                    jcache, compute_dtype=jnp.float32)
    got = model.decode_step(torch.from_numpy(token).long(), torch.from_numpy(lengths).long(),
                            cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if kv_quant:
        # The int8 codes are `q8_rows` of K/V that each package computes in
        # fp32 with its own summation order. A K or V value that lies on a
        # rounding edge then rounds to the neighbouring code, so the codes
        # are held to within one code, and the dequantised cache (code x
        # scale) to within one quantisation step (the slot's scale) of the
        # JAX cache; the scales, the logits and the tokens stay tight.
        stacked = {name: torch.stack([layer[i] for layer in cache]).numpy()
                   for i, name in enumerate(("k", "v", "k_scale", "v_scale"))}
        for name, got_c in stacked.items():
            assert got_c.dtype == np.asarray(jcache[name]).dtype, name
        for name in ("k", "v"):
            want_q, got_q = np.asarray(jcache[name]), stacked[name]
            want_s, got_s = np.asarray(jcache[f"{name}_scale"]), stacked[f"{name}_scale"]
            np.testing.assert_allclose(got_s, want_s, rtol=0, atol=ATOL, err_msg=name)
            code_diff = np.abs(got_q.astype(np.int32) - want_q.astype(np.int32))
            assert code_diff.max() <= 1, name
            step = want_s[..., None]
            deq_diff = np.abs(got_q * got_s[..., None] - want_q * step)
            assert (deq_diff <= step + ATOL).all(), name

    want_toks, want_lens = jax_generate(params, cfg, jnp.asarray(ids), jnp.asarray(lengths),
                                        max_new_tokens=6, top_k=1, compute_dtype=jnp.float32,
                                        kv_quant=kv_quant)
    got_toks, got_lens = generate(model, torch.from_numpy(ids), torch.from_numpy(lengths),
                                  max_new_tokens=6, top_k=1, kv_quant=kv_quant)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))


def test_quantized_mlp_bypasses_the_fused_mlp(monkeypatch):
    """A quantized MLP takes the unfused act(fc_1) * fc_2 branch, as the JAX
    package's `_mlp` does: K4's wrapper is never called."""
    from dualhyp_tpu_torch.models.gpt import quantize_model
    from dualhyp_tpu_torch.ops import swiglu

    cfg, params = _wide_params(3)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    quantize_model(merge_lora(model), "int4")
    assert model.blocks[0].mlp.fc_1.quant == "int4"
    assert model.wte.weight.dtype == torch.float32  # the embedding stays

    def boom(*a, **k):
        raise AssertionError("swiglu_mlp called on a quantized MLP")

    monkeypatch.setattr(swiglu, "swiglu_mlp", boom)
    ids = torch.from_numpy(_prompts(np.random.default_rng(0))[0]).long()
    assert torch.isfinite(model(ids)).all()


def test_q4_split_k_covers_every_group():
    # the wgmma kernel's splits (rows it takes, above int4.MID_ROWS or
    # where the middle kernel would take more than two waves; the decode
    # and middle kernels' parts meet in a cluster:
    # tests/test_torch_decode_tiles.py, tests/test_torch_mid_tiles.py)
    for rows, n, groups in [(17, 5632, 16), (64, 2048, 44), (129, 100, 5), (128, 32000, 16),
                            (3072, 5632, 16)]:
        splits, per = int4.split_k(rows, n, groups)
        assert splits * per >= groups > (splits - 1) * per


@pytest.mark.parametrize("flags", [[], ["--merge_lora", "--quantize", "int8"]])
def test_generate_cli_greedy_matches_jax(flags, tmp_path, capsys, monkeypatch):
    """`cli.generate` with --top_k 1 prints the text the JAX package's
    `cli.generate` prints, on a checkpoint the JAX package saved, also with
    the LoRA merged and the weights in int8. Both decode in bf16; the head
    is scaled up so that bf16 rounding cannot flip an argmax."""
    import sys

    from dualhyp_tpu.ckpt.io import save_params
    from dualhyp_tpu.cli import generate as jax_cli
    from dualhyp_tpu_torch.cli import generate as cli
    from tests.test_torch_decode import _write_tokenizer

    ckpt = tmp_path / "tiny-llama-test"
    ckpt.mkdir()
    vocab = _write_tokenizer(ckpt)
    cfg, params = _wide_params(4, vocab_size=vocab, block_size=64)
    params["lm_head"]["weight"] = params["lm_head"]["weight"] * 30.0
    save_params(ckpt / "dualhyp_model.npz", params)
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    monkeypatch.setitem(sys.modules, "transformers", None)
    args = ["--prompt", "the ASR the VSR", "--max_new_tokens", "6", "--top_k", "1",
            "--llm_checkpoint", str(ckpt), "--lora_r", "4", "--lora_alpha", "8", *flags]
    jax_cli.main(args)
    want = capsys.readouterr().out.splitlines()[0]
    got = cli.main(args + ["--device", "cpu"])
    assert got == [want]
    assert capsys.readouterr().out.splitlines()[0] == want
    assert len(want.split()) > 4


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_model_gives_the_bytes_of_quantize_tree(mode):
    """`quantize_model` (what --quantize runs on a loaded model) and
    `quantize_tree` (on a checkpoint's tree) quantize the same leaves to the
    same bytes; the embedding and the norms stay."""
    from dualhyp_tpu_torch.models.gpt import quantize_model

    cfg, params = _wide_params(5)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    want = dict(_flat(quant.quantize_tree(tree_from_model(model), mode)))
    got = dict(_flat(tree_from_model(quantize_model(model, mode))))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(_bits(got[key]), _bits(value), err_msg=key)
    assert "wte/weight" in got and "blocks/norm_1/scale" in got


def test_int8_cache_leaves_inactive_rows_alone(rng):
    """A decode step writes the int8 K/V and their scales only for the
    active rows: a finished row keeps its cache, as `generate` needs."""
    cfg, params = _wide_params(6)
    model = params_from_jax(params, _port_config(cfg), device="cpu", dtype=torch.float32)
    ids, lengths = _prompts(rng)
    cache = model.init_cache(3, 16, quantize="int8")
    assert [t.dtype for t in cache[0]] == [torch.int8] * 2 + [torch.float32] * 2
    model.prefill(torch.from_numpy(ids).long(), torch.from_numpy(lengths).long(), cache)
    before = [[t.clone() for t in layer] for layer in cache]
    model.decode_step(torch.tensor([4, 5, 6]), torch.from_numpy(lengths).long(), cache,
                      active=torch.tensor([True, False, True]))
    for layer, old in zip(cache, before):
        for new_t, old_t in zip(layer, old):
            assert torch.equal(new_t[1], old_t[1])
            assert not torch.equal(new_t[0], old_t[0])
    with pytest.raises(ValueError, match="KV-cache quantization"):
        model.init_cache(3, 16, quantize="int4")
