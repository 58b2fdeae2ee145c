"""The port's Whisper decoder against the JAX package's, on the CPU.

The same decoder weights (`init_decoder` of the JAX package, as numpy
arrays, through `ckpt.convert.decoder_from_jax`) and the same seeded inputs
go through both packages: the full forward (`decode_logits`, with the
cross-attention logits of `decode_logits_with_cross_qk`), the cross K/V
(`precompute_cross_kv`, float and int8), a walk of cached steps
(`decode_step_cached`, float and int8 cross K/V), the causal prefill
(`prefill_cache`, shared and ragged) and the split-cache step with a shared
prompt, a ragged batch and the int8 self cache. At fp32 every output is held
to 1e-5 (with the int8 self cache, whose codes may differ by one at a
rounding tie, the logits to 1e-3); the port's layouts differ (the cross K/V (L, U, H, S, hd) against
the JAX package's (L, U, n_state, S), the self cache (L, B, H, T, hd)
against (L, B, T, n_state)) and the tests permute before they compare. At
bf16 both packages round at the same points; the logits are held to 0.05
(a few bf16 ulps of logits of magnitude ~10: sums taken in another order
before a rounding). int4 weights (width 256, the smallest that is
quantized): `quantize_tree` gives the JAX package's bytes, and the
logits agree to 1e-4 (the port's plain K8 scales each group's sum, the JAX
package dequantizes first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import whisper as jw
from dualhyp_tpu.ops import quant as jquant
from dualhyp_tpu_torch.ckpt.convert import decoder_from_jax
from dualhyp_tpu_torch.models import whisper as tw
from dualhyp_tpu_torch.ops import quant as tquant

ATOL = 1e-5
BF16_LOGITS_ATOL = 0.05
INT4_ATOL = 1e-4
# int8 self cache: the new column's codes round fp32 values that agree to
# ~1e-7, so a code at a rounding tie may differ by one (one in ~2000 here);
# a logit then moves by ~1e-4
INT8_KV_ATOL = 1e-3
TINY = dict(n_vocab=96, n_ctx=64, n_state=32, n_head=4, n_layer=2)


def jax_decoder(seed=1, **kw):
    cfg = jw.WhisperDecoderConfig(**{**TINY, **kw})
    params = jax.tree_util.tree_map(np.array, jw.init_decoder(cfg, jax.random.key(seed)))
    return cfg, params


def port_cfg(cfg):
    return tw.WhisperDecoderConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def cross_to_jax_layout(t, n_head):
    """The port's (L, U, H, S, hd) K/V or (L, U, H, hd) scales in the JAX
    package's (L, U, n_state, S) / (L, U, n_state)."""
    t = t.float().numpy()
    if t.ndim == 5:
        l_, u, h, s, hd = t.shape
        return t.transpose(0, 1, 2, 4, 3).reshape(l_, u, h * hd, s)
    return t.reshape(t.shape[0], t.shape[1], -1)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=0)


def test_config_and_init():
    assert port_cfg(jw.WhisperDecoderConfig()) == tw.WhisperDecoderConfig()
    cfg = tw.WhisperDecoderConfig(**TINY)
    params = tw.init_decoder(cfg, torch.Generator().manual_seed(0), device="cpu")
    _, jparams = jax_decoder()
    shapes = jax.tree_util.tree_map(np.shape, jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    assert float(params["positional_embedding"].std()) < 0.02


def test_hf_and_openai_converters_match(rng):
    cfg, params = jax_decoder()
    hf = {}
    blocks = params["blocks"]
    names = {"attn": "self_attn", "cross": "encoder_attn"}
    for i in range(cfg.n_layer):
        pre = f"model.decoder.layers.{i}."
        for ours, theirs in names.items():
            for proj, hname in (("query", "q_proj"), ("key", "k_proj"), ("value", "v_proj"),
                                ("out", "out_proj")):
                for leaf, arr in blocks[ours][proj].items():
                    hf[f"{pre}{theirs}.{hname}.{leaf}"] = arr[i]
        for ours, theirs in (("attn_ln", "self_attn_layer_norm"),
                             ("cross_ln", "encoder_attn_layer_norm"),
                             ("mlp_ln", "final_layer_norm")):
            hf[f"{pre}{theirs}.weight"] = blocks[ours]["scale"][i]
            hf[f"{pre}{theirs}.bias"] = blocks[ours]["bias"][i]
        for fc in ("fc1", "fc2"):
            for leaf, arr in blocks["mlp"][fc].items():
                hf[f"{pre}{fc}.{leaf}"] = arr[i]
    hf["model.decoder.embed_tokens.weight"] = params["token_embedding"]
    hf["model.decoder.embed_positions.weight"] = params["positional_embedding"]
    hf["model.decoder.layer_norm.weight"] = params["ln"]["scale"]
    hf["model.decoder.layer_norm.bias"] = params["ln"]["bias"]
    want = jw.convert_hf_whisper_decoder(hf, cfg)
    got = tw.convert_hf_whisper_decoder(
        {k: torch.from_numpy(np.array(v)) for k, v in hf.items()}, port_cfg(cfg))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b.numpy()), want, got)

    sd = {f"decoder.{k}": v for k, v in {
        "token_embedding.weight": params["token_embedding"],
        "positional_embedding": params["positional_embedding"],
        "ln.weight": params["ln"]["scale"], "ln.bias": params["ln"]["bias"]}.items()}
    for i in range(cfg.n_layer):
        for ours, theirs in (("attn", "attn"), ("cross", "cross_attn")):
            for proj in ("query", "key", "value", "out"):
                for leaf, arr in blocks[ours][proj].items():
                    sd[f"decoder.blocks.{i}.{theirs}.{proj}.{leaf}"] = arr[i]
        for ours, theirs in (("attn_ln", "attn_ln"), ("cross_ln", "cross_attn_ln"),
                             ("mlp_ln", "mlp_ln")):
            sd[f"decoder.blocks.{i}.{theirs}.weight"] = blocks[ours]["scale"][i]
            sd[f"decoder.blocks.{i}.{theirs}.bias"] = blocks[ours]["bias"][i]
        for fc, idx in (("fc1", 0), ("fc2", 2)):
            for leaf, arr in blocks["mlp"][fc].items():
                sd[f"decoder.blocks.{i}.mlp.{idx}.{leaf}"] = arr[i]
    want = jw.convert_openai_whisper_decoder(sd, cfg)
    got = tw.convert_openai_whisper_decoder(sd, port_cfg(cfg))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b.numpy()), want, got)

    ecfg = jw.WhisperEncoderConfig(n_mels=16, n_ctx=32, n_state=32, n_head=4, n_layer=2)
    enc = jax.tree_util.tree_map(np.array, jw.init_encoder(ecfg, jax.random.key(2)))
    esd = {"encoder.conv1.weight": enc["conv1"]["weight"], "encoder.conv1.bias": enc["conv1"]["bias"],
           "encoder.conv2.weight": enc["conv2"]["weight"], "encoder.conv2.bias": enc["conv2"]["bias"],
           "encoder.ln_post.weight": enc["ln_post"]["scale"],
           "encoder.ln_post.bias": enc["ln_post"]["bias"]}
    for i in range(ecfg.n_layer):
        for proj in ("query", "key", "value", "out"):
            for leaf, arr in enc["blocks"]["attn"][proj].items():
                esd[f"encoder.blocks.{i}.attn.{proj}.{leaf}"] = arr[i]
        for ln in ("attn_ln", "mlp_ln"):
            esd[f"encoder.blocks.{i}.{ln}.weight"] = enc["blocks"][ln]["scale"][i]
            esd[f"encoder.blocks.{i}.{ln}.bias"] = enc["blocks"][ln]["bias"][i]
        for fc, idx in (("fc1", 0), ("fc2", 2)):
            for leaf, arr in enc["blocks"]["mlp"][fc].items():
                esd[f"encoder.blocks.{i}.mlp.{idx}.{leaf}"] = arr[i]
    want = jw.convert_openai_whisper_encoder(esd, ecfg)
    got = tw.convert_openai_whisper_encoder(esd, tw.WhisperEncoderConfig(**ecfg.__dict__))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b.numpy()), want, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_matches_jax(rng, dtype):
    cfg, params = jax_decoder()
    toks = rng.integers(0, cfg.n_vocab, size=(3, 9))
    feats = rng.normal(size=(3, 24, cfg.n_state)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    want = jw.decode_logits(params, cfg, jnp.asarray(toks, jnp.int32), jnp.asarray(feats),
                            compute_dtype=jdt)
    tp = decoder_from_jax(params, device="cpu")
    got = tw.decode_logits(tp, port_cfg(cfg), torch.from_numpy(toks), torch.from_numpy(feats),
                           compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (3, 9, cfg.n_vocab)
    close(want, got.numpy(), ATOL if dtype == "float32" else BF16_LOGITS_ATOL)
    if dtype == "float32":
        wl, wqk = jw.decode_logits_with_cross_qk(params, cfg, jnp.asarray(toks, jnp.int32),
                                                 jnp.asarray(feats))
        gl, gqk = tw.decode_logits_with_cross_qk(tp, port_cfg(cfg), torch.from_numpy(toks),
                                                 torch.from_numpy(feats))
        close(wl, gl.numpy())
        assert gqk.shape == (cfg.n_layer, 3, cfg.n_head, 9, 24)
        close(wqk, gqk.numpy())


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cross_kv_and_cached_steps_match_jax(rng, quantize):
    """precompute_cross_kv, then a walk of 8 cached steps (every position's
    K/V in the cache, positions 0..7) against the JAX package's, and at
    fp32 without quantization against the full forward too."""
    cfg, params = jax_decoder()
    pcfg = port_cfg(cfg)
    tp = decoder_from_jax(params, device="cpu")
    toks = rng.integers(0, cfg.n_vocab, size=(3, 8))
    feats = rng.normal(size=(3, 24, cfg.n_state)).astype(np.float32)
    jcross = jw.precompute_cross_kv(params, cfg, jnp.asarray(feats), quantize=quantize)
    tcross = tw.precompute_cross_kv(tp, pcfg, torch.from_numpy(feats), quantize=quantize)
    assert len(tcross) == len(jcross)
    for want, got in zip(jcross, tcross):
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(np.asarray(want), cross_to_jax_layout(got, cfg.n_head))
        else:
            close(want, cross_to_jax_layout(got, cfg.n_head))
    full = np.asarray(jw.decode_logits(params, cfg, jnp.asarray(toks, jnp.int32),
                                       jnp.asarray(feats)))
    jcache = jw.init_self_cache(cfg, 3, 10)
    tcache = tw.init_self_cache(pcfg, 3, 10)
    for pos in range(8):
        want, jcache = jw.decode_step_cached(params, cfg, jnp.asarray(toks[:, pos], jnp.int32),
                                             pos, jcache, jcross)
        got = tw.decode_step_cached(tp, pcfg, torch.from_numpy(toks[:, pos]), pos, tcache,
                                    tcross)
        close(want, got.numpy())
        if quantize is None:
            close(full[:, pos], got.numpy())
    jk = np.asarray(jcache["k"])[:, :, :8]  # (L, B, T, n_state)
    tk = tcache["k"][:, :, :, :8].permute(0, 1, 3, 2, 4).reshape(jk.shape).numpy()
    close(jk, tk)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_cache_matches_jax(rng, ragged):
    cfg, params = jax_decoder()
    tp = decoder_from_jax(params, device="cpu")
    toks = rng.integers(0, cfg.n_vocab, size=(3, 7))
    feats = rng.normal(size=(3, 24, cfg.n_state)).astype(np.float32)
    off = np.asarray([0, 2, 5]) if ragged else None
    jcross = jw.precompute_cross_kv(params, cfg, jnp.asarray(feats))
    tcross = tw.precompute_cross_kv(tp, port_cfg(cfg), torch.from_numpy(feats))
    want = jw.prefill_cache(params, cfg, jnp.asarray(toks, jnp.int32), jcross,
                            pos_offset=None if off is None else jnp.asarray(off, jnp.int32))
    got = tw.prefill_cache(tp, port_cfg(cfg), torch.from_numpy(toks), tcross,
                           pos_offset=None if off is None else torch.from_numpy(off))
    for a, b in zip(want, got):
        close(a, b.numpy())


@pytest.mark.parametrize("quant_kv", [None, "int8"])
def test_split_cache_step_matches_jax(rng, quant_kv):
    """The beam's protocol: a shared ragged prompt (prefix_kv, prefix_valid,
    per-row position offsets), U = 2 utterances of R = 3 rows, 4 steps with
    the rows re-parented between them (the port by index, the JAX package
    through its one-hot ancestor map), float or int8 self and cross K/V."""
    from dualhyp_tpu.infer.whisper_device_beam import _prefill as jprefill
    from dualhyp_tpu_torch.infer.whisper_device_beam import _prefill as tprefill

    cfg, params = jax_decoder()
    pcfg = port_cfg(cfg)
    tp = decoder_from_jax(params, device="cpu")
    u, r, p = 2, 3, 5
    b = u * r
    feats = rng.normal(size=(u, 24, cfg.n_state)).astype(np.float32)
    pmat = rng.integers(0, cfg.n_vocab, size=(u, p))
    off = np.asarray([0, 2])
    jcross = jw.precompute_cross_kv(params, cfg, jnp.asarray(feats), quantize=quant_kv)
    tcross = tw.precompute_cross_kv(tp, pcfg, torch.from_numpy(feats), quantize=quant_kv)
    jpre = jprefill(params, jcross, jnp.asarray(pmat[:, :-1].T, jnp.int32),
                    jnp.asarray(off, jnp.int32), dec_cfg=cfg, n_utt=u, quantize=quant_kv)
    tpre = tprefill(tp, pcfg, tcross, torch.from_numpy(pmat[:, :-1]), torch.from_numpy(off),
                    quant_kv)
    for want, got in zip(jpre, tpre):
        if got.dtype == torch.int8:
            np.testing.assert_array_equal(np.asarray(want), cross_to_jax_layout(got, cfg.n_head))
        else:
            close(want, cross_to_jax_layout(got, cfg.n_head))
    valid = np.arange(p - 1)[None, :] >= off[:, None]
    row_off = np.repeat(off, r)
    steps = 4
    jcache = jw.init_self_cache(cfg, b, steps, quantize=quant_kv)
    tcache = tw.init_self_cache(pcfg, b, steps, quantize=quant_kv)
    anc = np.zeros((b, steps), np.int64)  # each row's ancestor slot a column
    parents = None
    for s in range(steps):
        toks = rng.integers(0, cfg.n_vocab, size=b)
        anc_step = anc.copy()
        anc_step[:, s] = np.arange(b) % r
        onehot = np.zeros((b, b, steps), np.float32)  # flat (B, B, T)
        for row in range(b):
            for t in range(steps):
                onehot[row, (row // r) * r + anc_step[row, t], t] = 1.0
        oh = jnp.asarray(onehot, jnp.int8 if quant_kv else jnp.float32)
        scales = None
        if quant_kv:
            scales = tuple(jnp.einsum("bst,lst->lbt", jnp.asarray(onehot), jcache[k])
                           for k in ("k_scale", "v_scale"))
        want, cols = jw.decode_step_cached(
            params, cfg, jnp.asarray(toks, jnp.int32), p - 1 + s, jcache, jcross,
            anc_onehot=oh, self_kv_scales=scales, pos_offset=jnp.asarray(row_off, jnp.int32),
            prefix_kv=jpre, prefix_valid=jnp.asarray(valid), cache_pos=s)
        for key, col in cols.items():
            idx = (slice(None), slice(None), s)
            jcache[key] = jcache[key].at[idx].set(col)
        got = tw.decode_step_cached(
            tp, pcfg, torch.from_numpy(toks), p - 1 + s, tcache, tcross, row_gather=parents,
            pos_offset=torch.from_numpy(row_off), prefix_kv=tpre,
            prefix_valid=torch.from_numpy(valid), cache_pos=s)
        close(want, got.numpy(), INT8_KV_ATOL if quant_kv else ATOL)
        if quant_kv:  # a code may flip at a rounding tie, by one
            for key in ("k", "v"):
                jcol = np.asarray(cols[key]).astype(np.int32)
                tcol = tcache[key][:, :, :, s].reshape(jcol.shape).numpy().astype(np.int32)
                assert np.abs(jcol - tcol).max() <= 1
                assert (jcol != tcol).mean() < 0.01
        # re-parent: each row takes a random parent within its utterance
        par = np.concatenate([g * r + rng.integers(0, r, size=r) for g in range(u)])
        anc = anc_step[par]
        parents = torch.from_numpy(par)


def test_quantize_tree_int4_decoder_matches_jax(rng):
    cfg, params = jax_decoder(n_state=256, n_head=4, n_layer=1, n_vocab=128)
    jq = jquant.quantize_tree(params, "int4")
    tq = tquant.quantize_tree(decoder_from_jax(params, device="cpu"), "int4")
    leaves = jax.tree_util.tree_leaves_with_path(jq)
    assert any("weight_q4" in jax.tree_util.keystr(k) for k, _ in leaves)
    flat = dict(jax.tree_util.tree_leaves_with_path(tq))
    for key, want in leaves:
        got = flat[key]
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    toks = rng.integers(0, cfg.n_vocab, size=(2, 5))
    feats = rng.normal(size=(2, 16, cfg.n_state)).astype(np.float32)
    want = jw.decode_logits(jq, cfg, jnp.asarray(toks, jnp.int32), jnp.asarray(feats))
    tqp = decoder_from_jax(jq, device="cpu")
    assert tqp["blocks"]["mlp"]["fc1"]["weight_q4"].dtype == torch.int8
    got = tw.decode_logits(tqp, port_cfg(cfg), torch.from_numpy(toks), torch.from_numpy(feats))
    close(want, got.numpy(), INT4_ATOL)
