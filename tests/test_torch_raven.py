"""The port's VSR/AVSR models against the JAX package's, on the CPU.

Random trees are built as the JAX package's tests build them
(`tests/test_batch_encode.py`: `_rnd_builders`, `_enc_params`,
`_conv1d_params`, here drawn with numpy) at tiny widths (16-32, 2 blocks; the Conv3D frontend's
trunk narrowed to widths 8-32), carried across by
`ckpt.convert.raven_from_jax`, and run through both packages on the same
seeded numpy inputs: the Conv3D + ResNet-18 frontend, the encoder under
`rel_mha`, `legacy_rel_mha` and `mha` (with macaron + conv module), the
AVSR fusion with its Conv1D frontend and MLP head, the lipreading
ShuffleNetV2 trunk and TCN, the ESPnet decoder (full forward, cached steps,
CTC head) and LM, and the torch-state-dict converters. fp32 to 1e-5; bf16
to BF16_ATOL (below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import avsr as javsr
from dualhyp_tpu.models import espnet_decoder as jed
from dualhyp_tpu.models import espnet_lm as jlm
from dualhyp_tpu.models import lipreading as jlip
from dualhyp_tpu.models import raven as jraven
from dualhyp_tpu_torch.ckpt.convert import raven_from_jax
from dualhyp_tpu_torch.models import avsr as tavsr
from dualhyp_tpu_torch.models import espnet_decoder as ted
from dualhyp_tpu_torch.models import espnet_lm as tlm
from dualhyp_tpu_torch.models import lipreading as tlip
from dualhyp_tpu_torch.models import raven as traven

ATOL = 1e-5
# bf16: both packages round every op's output to bf16 (2^-8 relative) in
# their own order; over 2 blocks the outputs, O(1), stay within a few ulps
BF16_ATOL = 6e-2

ENC = dict(idim=16, attention_dim=32, attention_heads=4, linear_units=48, num_blocks=2)
ENC_CFGS = {
    "rel_mha": dict(ENC),
    "legacy_rel_mha": dict(ENC, attn_layer_type="legacy_rel_mha"),
    "mha": dict(ENC, attn_layer_type="mha"),
    "conformer": dict(ENC, macaron_style=True, use_cnn_module=True, cnn_module_kernel=5),
}


def _rnd_builders(seed):
    """`tests/test_batch_encode._rnd_builders` drawn with numpy (its
    jax.random draws compile once per shape: ~18 s for an AVSR tree)."""
    gen = np.random.default_rng(seed)

    def rnd(shape, scale=0.1):
        return (gen.normal(size=shape) * scale).astype(np.float32)

    def lin(o, i):
        return {"weight": rnd((o, i)), "bias": rnd((o,))}

    def ln(d):
        return {"weight": 1 + rnd((d,)), "bias": rnd((d,))}

    def bn(d):
        return {"running_mean": rnd((d,)), "running_var": 1 + rnd((d,)) ** 2,
                "weight": 1 + rnd((d,)), "bias": rnd((d,))}

    return rnd, lin, ln, bn


def _enc_params(cfg, seed=0):
    """`tests/test_batch_encode._enc_params` on the numpy builders."""
    rnd, lin, ln, bn = _rnd_builders(seed)
    d, h, lu = cfg.attention_dim, cfg.attention_heads, cfg.linear_units
    layers = {}
    for i in range(cfg.num_blocks):
        leaf = {"norm_mha": ln(d),
                "self_attn": {"linear_q": lin(d, d), "linear_k": lin(d, d),
                              "linear_v": lin(d, d), "linear_out": lin(d, d)},
                "norm_ff": ln(d), "feed_forward": {"w_1": lin(lu, d), "w_2": lin(d, lu)}}
        if cfg.attn_layer_type in ("rel_mha", "legacy_rel_mha"):
            leaf["self_attn"].update(linear_pos={"weight": rnd((d, d))},
                                     pos_bias_u=rnd((h, d // h)), pos_bias_v=rnd((h, d // h)))
        if cfg.macaron_style:
            leaf["feed_forward_macaron"] = {"w_1": lin(lu, d), "w_2": lin(d, lu)}
            leaf["norm_ff_macaron"] = ln(d)
        if cfg.use_cnn_module:
            k = cfg.cnn_module_kernel
            leaf["conv_module"] = {
                "pointwise_cov1": {"weight": rnd((2 * d, d, 1)), "bias": rnd((2 * d,))},
                "depthwise_conv": {"weight": rnd((d, 1, k)), "bias": rnd((d,))},
                "norm": bn(d),
                "pointwise_cov2": {"weight": rnd((d, d, 1)), "bias": rnd((d,))}}
            leaf["norm_conv"] = ln(d)
            leaf["norm_final"] = ln(d)
        layers[str(i)] = leaf
    return {"embed": {"linear": lin(d, cfg.idim)}, "layers": layers, "after_norm": ln(d)}


def _conv1d_params(seed=3):
    """`tests/test_batch_encode._conv1d_params` (the real 64-512 layout) on
    the numpy builders."""
    rnd, _, _, bn = _rnd_builders(seed)

    def block(cin, cout, downsample):
        leaf = {"conv1": {"weight": rnd((cout, cin, 3))}, "bn1": bn(cout),
                "conv2": {"weight": rnd((cout, cout, 3))}, "bn2": bn(cout)}
        if downsample:
            leaf["downsample"] = {"conv": {"weight": rnd((cout, cin, 1))}, "bn": bn(cout)}
        return leaf

    params = {"conv1": {"weight": rnd((64, 1, 80))}, "bn1": bn(64)}
    for name, (cin, cout) in {"layer1": (64, 64), "layer2": (64, 128), "layer3": (128, 256),
                              "layer4": (256, 512)}.items():
        params[name] = {"0": block(cin, cout, name != "layer1"), "1": block(cout, cout, False)}
    return params


def close(got, want, atol=ATOL):
    """Within `atol` of the output's largest magnitude (at least 1): a tolerance
    relative to the output's scale, which grows past 100 in the frontends."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def jit(fn, *static):
    """The JAX function compiled once (its eager ops compile one by one)."""
    return jax.jit(fn, static_argnums=static)


def cfgs(**fields):
    return jraven.RavenEncoderConfig(**fields), traven.RavenEncoderConfig(**fields)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port(tree, dtype=None):
    return raven_from_jax(tree, device="cpu", dtype=dtype)


def frontend_tree(seed=11, widths=(8, 8, 16, 16, 32)):
    """A Conv3D + ResNet-18 tree with a narrow trunk (numpy)."""
    rnd, _, _, bn = _rnd_builders(seed)

    def block(cin, cout, downsample):
        leaf = {"conv1": {"weight": rnd((cout, cin, 3, 3))}, "bn1": bn(cout),
                "conv2": {"weight": rnd((cout, cout, 3, 3))}, "bn2": bn(cout)}
        if downsample:
            leaf["downsample"] = {"conv": {"weight": rnd((cout, cin, 1, 1))}, "bn": bn(cout)}
        return leaf

    resnet, cin = {}, widths[0]
    for li, cout in enumerate(widths[1:]):
        resnet[f"layer{li + 1}"] = {"0": block(cin, cout, li > 0), "1": block(cout, cout, False)}
        cin = cout
    return to_np({"conv3d": {"weight": rnd((widths[0], 1, 5, 7, 7))}, "bn3d": bn(widths[0]),
                  "resnet": resnet})


def decoder_tree(seed, odim=14, d=16, units=32, blocks=2):
    _, lin, ln, _ = _rnd_builders(seed)
    rnd = _rnd_builders(seed + 100)[0]

    def attn():
        return {k: lin(d, d) for k in ("linear_q", "linear_k", "linear_v", "linear_out")}

    return to_np({"embed": {"weight": rnd((odim, d), scale=1.0)},
                  "layers": {str(i): {"norm1": ln(d), "norm2": ln(d), "norm3": ln(d),
                                      "self_attn": attn(), "src_attn": attn(),
                                      "feed_forward": {"w_1": lin(units, d),
                                                       "w_2": lin(d, units)}}
                             for i in range(blocks)},
                  "after_norm": ln(d), "output_layer": lin(odim, d)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv3d_frontend_matches_jax(rng, dtype):
    tree = frontend_tree()
    video = rng.normal(size=(2, 1, 5, 24, 24)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jit(jraven.conv3d_frontend)(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree),
        jnp.asarray(video, jdt)).astype(jnp.float32)
    got = traven.conv3d_frontend(port(tree, tdt), torch.from_numpy(video).to(tdt)).float()
    assert got.shape == (2, 5, 32)
    close(got, want, ATOL if dtype == "float32" else BF16_ATOL)


@pytest.mark.parametrize("name", sorted(ENC_CFGS))
def test_encode_matches_jax(rng, name):
    jcfg, tcfg = cfgs(**ENC_CFGS[name])
    tree = to_np(_enc_params(jcfg, seed=2))
    feats = rng.normal(size=(3, 11, 16)).astype(np.float32)
    mask = np.arange(11)[None, :] < np.array([11, 7, 9])[:, None]
    want = jit(jraven.encode, 1)(to_jax(tree), jcfg, jnp.asarray(feats), jnp.asarray(mask))
    got = traven.encode(port(tree), tcfg, torch.from_numpy(feats), torch.from_numpy(mask))
    close(got, want)


def test_encode_bf16_matches_jax(rng):
    jcfg, tcfg = cfgs(**ENC_CFGS["conformer"])
    tree = to_np(_enc_params(jcfg, seed=3))
    feats = rng.normal(size=(2, 9, 16)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([9, 6])[:, None]
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    want = jit(jraven.encode, 1)(jtree, jcfg, jnp.asarray(feats, jnp.bfloat16),
                                 jnp.asarray(mask)).astype(jnp.float32)
    ttree = port(tree, torch.bfloat16)
    assert traven.encode_dtype(ttree) == torch.bfloat16
    got = traven.encode(ttree, tcfg, torch.from_numpy(feats).bfloat16(), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    close(got.float(), want, BF16_ATOL)


@pytest.mark.parametrize("name", ["conformer", "rel_mha"])
def test_padded_batch_equals_per_utterance_encodes(rng, name):
    """A right-zero-padded masked batch gives each utterance's own encode at
    its real frames (the conformer's conv module masks its padding)."""
    _, tcfg = cfgs(**ENC_CFGS[name])
    tree = port(to_np(_enc_params(cfgs(**ENC_CFGS[name])[0], seed=4)))
    lengths = [9, 5, 12]
    feats = [rng.normal(size=(t, 16)).astype(np.float32) for t in lengths]
    batch = np.zeros((3, 16, 16), np.float32)
    for i, f in enumerate(feats):
        batch[i, : len(f)] = f
    mask = np.arange(16)[None, :] < np.asarray(lengths)[:, None]
    got = traven.encode(tree, tcfg, torch.from_numpy(batch), torch.from_numpy(mask))
    for i, f in enumerate(feats):
        want = traven.encode(tree, tcfg, torch.from_numpy(f[None]))[0]
        close(got[i, : lengths[i]], want)


def test_encode_reads_mask_shapes_as_jax_does(rng):
    """A 2-D mask whose first dimension is the batch is a (B, S) padding
    mask; a square one with B == T is read the same way (the JAX rule), and
    a 3-D (1, T, T) causal mask is an attention mask."""
    jcfg, tcfg = cfgs(**ENC_CFGS["mha"])
    tree = to_np(_enc_params(jcfg, seed=5))
    feats = rng.normal(size=(4, 4, 16)).astype(np.float32)
    for mask in (np.tril(np.ones((4, 4), bool)), np.tril(np.ones((4, 4), bool))[None]):
        want = jit(jraven.encode, 1)(to_jax(tree), jcfg, jnp.asarray(feats), jnp.asarray(mask))
        got = traven.encode(port(tree), tcfg, torch.from_numpy(feats), torch.from_numpy(mask))
        close(got, want)


@pytest.mark.parametrize("norm", ["batch", "layer"])
def test_avsr_encode_and_conv1d_frontend_match_jax(rng, norm):
    jcfg, tcfg = cfgs(**ENC_CFGS["conformer"])
    _, lin, ln, bn = _rnd_builders(7)
    tree = to_np({"video_encoder": _enc_params(jcfg, seed=8),
                  "audio_encoder": _enc_params(jcfg, seed=9),
                  "fusion": {"fc1": lin(24, 64), "norm": bn(24) if norm == "batch" else ln(24),
                             "fc2": lin(32, 24)},
                  "audio_frontend": _conv1d_params(10)})
    audio = rng.normal(size=(2, 9 * 640 + 100)).astype(np.float32)
    lengths = np.array([9 * 640 + 100, 6 * 640 + 7])
    audio[1, lengths[1]:] = 0
    want_a = jit(javsr.conv1d_frontend)(to_jax(tree["audio_frontend"]), jnp.asarray(audio),
                                        jnp.asarray(lengths))
    ttree = port(tree)
    got_a = tavsr.conv1d_frontend(ttree["audio_frontend"], torch.from_numpy(audio),
                                  torch.from_numpy(lengths))
    assert got_a.shape == (2, 9, 512)
    close(got_a, want_a)
    # the padded row at its real frames is its own unpadded run
    alone = tavsr.conv1d_frontend(ttree["audio_frontend"],
                                  torch.from_numpy(audio[1:, : lengths[1]]))
    close(got_a[1, :6], alone[0])

    vfeats = rng.normal(size=(2, 10, 16)).astype(np.float32)
    afeats = rng.normal(size=(2, 9, 16)).astype(np.float32)
    vmask = np.arange(10)[None, :] < np.array([10, 7])[:, None]
    amask = np.arange(9)[None, :] < np.array([9, 6])[:, None]
    want = jax.jit(javsr.avsr_encode, static_argnums=(1, 2))(
        to_jax(tree), jcfg, jcfg, jnp.asarray(vfeats), jnp.asarray(afeats),
        video_mask=jnp.asarray(vmask), audio_mask=jnp.asarray(amask))
    got = tavsr.avsr_encode(ttree, tcfg, tcfg, torch.from_numpy(vfeats),
                            torch.from_numpy(afeats), video_mask=torch.from_numpy(vmask),
                            audio_mask=torch.from_numpy(amask))
    assert got.shape == (2, 9, 32)
    close(got, want)


def _shufflenet_state(rng, c_in=8, stage_out=(16, 32), repeats=(2, 2), c_last=24):
    """A ShuffleNetV2 trunk's torch state_dict (numpy), as the reference
    names it."""
    state = {}

    def conv(key, o, i, k):
        state[key + ".weight"] = rng.normal(size=(o, i, k, k)).astype(np.float32) * 0.3

    def bn(key, c):
        state[key + ".weight"] = (1 + rng.normal(size=c) * 0.1).astype(np.float32)
        state[key + ".bias"] = (rng.normal(size=c) * 0.1).astype(np.float32)
        state[key + ".running_mean"] = (rng.normal(size=c) * 0.1).astype(np.float32)
        state[key + ".running_var"] = (1 + rng.normal(size=c) ** 2 * 0.1).astype(np.float32)

    idx, cin = 0, c_in
    for cout, reps in zip(stage_out, repeats):
        half = cout // 2
        for rep in range(reps):
            pre = f"features.{idx}."
            if rep == 0:
                conv(pre + "banch1.0", cin, 1, 3)
                bn(pre + "banch1.1", cin)
                conv(pre + "banch1.2", half, cin, 1)
                bn(pre + "banch1.3", half)
                b2_in = cin
            else:
                b2_in = half
            conv(pre + "banch2.0", half, b2_in, 1)
            bn(pre + "banch2.1", half)
            conv(pre + "banch2.3", half, 1, 3)
            bn(pre + "banch2.4", half)
            conv(pre + "banch2.5", half, half, 1)
            bn(pre + "banch2.6", half)
            idx += 1
        cin = cout
    conv("conv_last.0", c_last, cin, 1)
    bn("conv_last.1", c_last)
    return state


def test_lipreading_trunk_and_tcn_match_jax(rng):
    state = _shufflenet_state(rng)
    jtrunk = jlip.convert_shufflenet_trunk(state, stage_repeats=(2, 2))
    ttrunk = tlip.convert_shufflenet_trunk(state, stage_repeats=(2, 2))
    x = rng.normal(size=(3, 8, 16, 16)).astype(np.float32)
    want = jlip.shufflenet_v2_trunk(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a, jtrunk), jnp.asarray(x))
    got = tlip.shufflenet_v2_trunk(ttrunk, torch.from_numpy(x))
    assert got.shape == (3, 24)
    close(got, want)

    tcn_state = {}
    for i, (cin, cout) in enumerate(((24, 16), (16, 16))):
        for conv, ci in (("conv1", cin), ("conv2", cout)):
            tcn_state[f"network.{i}.{conv}.weight"] = rng.normal(
                size=(cout, ci, 3)).astype(np.float32) * 0.3
            tcn_state[f"network.{i}.{conv}.bias"] = rng.normal(size=cout).astype(np.float32) * 0.1
        for b in ("batchnorm1", "batchnorm2"):
            tcn_state[f"network.{i}.{b}.weight"] = (1 + rng.normal(size=cout) * 0.1).astype(
                np.float32)
            tcn_state[f"network.{i}.{b}.bias"] = rng.normal(size=cout).astype(np.float32) * 0.1
            tcn_state[f"network.{i}.{b}.running_mean"] = np.zeros(cout, np.float32)
            tcn_state[f"network.{i}.{b}.running_var"] = np.ones(cout, np.float32)
        if cin != cout:
            tcn_state[f"network.{i}.downsample.weight"] = rng.normal(
                size=(cout, cin, 1)).astype(np.float32) * 0.3
            tcn_state[f"network.{i}.downsample.bias"] = np.zeros(cout, np.float32)
    seq = rng.normal(size=(2, 13, 24)).astype(np.float32)
    want = jit(jlip.temporal_conv_net, 2)(to_jax(jlip.convert_tcn(tcn_state, 2)),
                                          jnp.asarray(seq), 3)
    got = tlip.temporal_conv_net(tlip.convert_tcn(tcn_state, 2), torch.from_numpy(seq), 3)
    assert got.shape == (2, 13, 16)
    close(got, want)


def test_decoder_full_forward_cached_steps_and_ctc_match_jax(rng):
    jcfg = jed.EspnetDecoderConfig(odim=14, attention_dim=16, attention_heads=2,
                                   linear_units=32, num_blocks=2)
    tcfg = ted.EspnetDecoderConfig(odim=14, attention_dim=16, attention_heads=2,
                                   linear_units=32, num_blocks=2)
    tree = decoder_tree(12)
    jtree, ttree = to_jax(tree), port(tree)
    memory = rng.normal(size=(2, 9, 16)).astype(np.float32)
    mem_len = np.array([9, 6])
    tokens = rng.integers(0, 14, size=(2, 5))
    want = jit(jed.decode_logits, 1)(jtree, jcfg, jnp.asarray(tokens), jnp.asarray(memory),
                                     jnp.asarray(mem_len))
    got = ted.decode_logits(ttree, tcfg, torch.from_numpy(tokens), torch.from_numpy(memory),
                            memory_length=torch.from_numpy(mem_len))
    close(got, want)

    _, lin, _, _ = _rnd_builders(13)
    ctc = to_np({"ctc_lo": lin(14, 16)})
    close(ted.ctc_log_probs(port(ctc), torch.from_numpy(memory)),
          jed.ctc_log_probs(to_jax(ctc), jnp.asarray(memory)))

    # cached steps: 2 utterances x 3 rows, 5 positions, against the JAX
    # cached step and the port's own full forward
    rows = np.repeat(tokens, 3, axis=0)
    jkv = jed.precompute_cross_kv(jtree, jcfg, jnp.asarray(memory))
    tkv = ted.precompute_cross_kv(ttree, tcfg, torch.from_numpy(memory))
    for key in ("k", "v"):
        close(tkv[key], jkv[key])
    jcache = jed.init_self_cache(jcfg, 6, 8)
    tcache = ted.init_self_cache(tcfg, 6, 8)
    table = jnp.asarray(jraven.abs_positions(8, 16))
    ttable = ted.position_table(tcfg, 8)
    full = ted.decode_logits(ttree, tcfg, torch.from_numpy(rows),
                             torch.from_numpy(np.repeat(memory, 3, axis=0)),
                             memory_length=torch.from_numpy(np.repeat(mem_len, 3)))
    step = jax.jit(jed.decode_step_cached, static_argnums=(1,), static_argnames=("n_per_group",))
    for pos in range(5):
        jl, jcache = step(jtree, jcfg, jnp.asarray(rows[:, pos]), pos, jcache, jkv,
                          jnp.asarray(mem_len), table, n_per_group=3)
        tl, tcache = ted.decode_step_cached(ttree, tcfg, torch.from_numpy(rows[:, pos]), pos,
                                            tcache, tkv, torch.from_numpy(mem_len), ttable,
                                            n_per_group=3)
        close(tl, jl)
        close(tl, full[:, pos])


def test_decoder_bf16_cached_step_matches_jax(rng):
    """bf16 weights: the cached step computes in bf16 with fp32 scores, the
    cross K/V in fp32 from the fp32 memory, as in the JAX package."""
    jcfg = jed.EspnetDecoderConfig(odim=14, attention_dim=16, attention_heads=2,
                                   linear_units=32, num_blocks=2)
    tcfg = ted.EspnetDecoderConfig(odim=14, attention_dim=16, attention_heads=2,
                                   linear_units=32, num_blocks=2)
    tree = decoder_tree(14)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    ttree = port(tree, torch.bfloat16)
    memory = rng.normal(size=(1, 7, 16)).astype(np.float32)
    rows = rng.integers(0, 14, size=(4, 3))
    jkv = jed.precompute_cross_kv(jtree, jcfg, jnp.asarray(memory))
    tkv = ted.precompute_cross_kv(ttree, tcfg, torch.from_numpy(memory))
    jcache = jed.init_self_cache(jcfg, 4, 4, dtype=jnp.bfloat16)
    tcache = ted.init_self_cache(tcfg, 4, 4, dtype=traven.first_leaf_dtype(ttree))
    assert tcache["k"].dtype == torch.bfloat16
    step = jax.jit(jed.decode_step_cached, static_argnums=(1,), static_argnames=("n_per_group",))
    for pos in range(3):
        jl, jcache = step(jtree, jcfg, jnp.asarray(rows[:, pos]), pos, jcache, jkv,
                          jnp.asarray([7]), jnp.asarray(jraven.abs_positions(4, 16)),
                          n_per_group=4)
        tl, tcache = ted.decode_step_cached(ttree, tcfg, torch.from_numpy(rows[:, pos]), pos,
                                            tcache, tkv, torch.tensor([7]),
                                            ted.position_table(tcfg, 4), n_per_group=4)
        close(tl.float(), jnp.asarray(jl, jnp.float32), BF16_ATOL)


def test_lm_logprobs_match_jax(rng):
    jcfg = jlm.EspnetLMConfig(n_vocab=14, embed_unit=8, att_unit=16, head=2, unit=32, layer=2)
    tcfg = tlm.EspnetLMConfig(n_vocab=14, embed_unit=8, att_unit=16, head=2, unit=32, layer=2)
    rnd, lin, ln, _ = _rnd_builders(15)
    enc = _enc_params(jlm_encoder_config(jcfg), seed=16)
    enc["embed"]["norm"] = ln(16)
    tree = to_np({"embed": {"weight": rnd((14, 8), scale=1.0)}, "encoder": enc,
                  "decoder": lin(14, 16)})
    for batch, t in ((3, 5), (4, 4)):  # B == T: the mask must stay causal
        tokens = rng.integers(0, 14, size=(batch, t))
        want = jit(jlm.lm_logprobs, 1)(to_jax(tree), jcfg, jnp.asarray(tokens))
        got = tlm.lm_logprobs(port(tree), tcfg, torch.from_numpy(tokens))
        close(got, want)
        at = tlm.lm_logprobs_at(port(tree), tcfg, torch.from_numpy(
            np.pad(tokens, ((0, 0), (0, 3)))), t - 1)
        close(at, want)


def jlm_encoder_config(cfg):
    return jraven.RavenEncoderConfig(idim=cfg.embed_unit, attention_dim=cfg.att_unit,
                                     attention_heads=cfg.head, linear_units=cfg.unit,
                                     num_blocks=cfg.layer, attn_layer_type="mha")


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _assert_same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=str(key))


def test_state_dict_converters_match_jax(rng):
    """The torch-state-dict converters give the JAX package's trees."""
    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    bn = ("weight", "bias", "running_mean", "running_var")
    state = {"frontend3D.0.weight": arr(4, 1, 5, 7, 7),
             **{f"frontend3D.1.{k}": arr(4) for k in bn}}
    for li in range(1, 5):
        for bi in ("0", "1"):
            pre = f"trunk.layer{li}.{bi}."
            for c in ("conv1", "conv2"):
                state[pre + c + ".weight"] = arr(4, 4, 3, 3)
            for b in ("bn1", "bn2"):
                state.update({f"{pre}{b}.{k}": arr(4) for k in bn})
            if bi == "0" and li > 1:
                state[pre + "downsample.0.weight"] = arr(4, 4, 1, 1)
                state.update({f"{pre}downsample.1.{k}": arr(4) for k in bn})
    _assert_same_tree(traven.convert_conv3d_frontend(state),
                      jraven.convert_conv3d_frontend(state))
    conv1d = {k.replace("frontend3D.0", "trunk.conv1").replace("frontend3D.1", "trunk.bn1"): v
              for k, v in state.items()}
    _assert_same_tree(tavsr.convert_conv1d_frontend(conv1d), javsr.convert_conv1d_frontend(conv1d))

    jcfg, tcfg = cfgs(**dict(ENC_CFGS["rel_mha"], num_blocks=1))
    enc = {"encoder.embed.0.weight": arr(32, 16), "encoder.embed.0.bias": arr(32),
           "encoder.embed.1.weight": arr(32), "encoder.embed.1.bias": arr(32),
           "encoder.encoders.0.self_attn.linear_q.weight": arr(32, 32),
           "encoder.encoders.0.self_attn.pos_bias_u": arr(4, 8),
           "encoder.after_norm.weight": arr(32), "encoder.after_norm.bias": arr(32)}
    _assert_same_tree(traven.convert_espnet_encoder(enc, tcfg, prefix="encoder."),
                      jraven.convert_espnet_encoder(enc, jcfg, prefix="encoder."))
    dec = {"decoder.embed.0.weight": arr(14, 16), "decoder.after_norm.weight": arr(16),
           "decoder.output_layer.weight": arr(14, 16),
           "decoder.decoders.0.src_attn.linear_k.weight": arr(16, 16)}
    dcfg = dict(odim=14, attention_dim=16, attention_heads=2, linear_units=32, num_blocks=1)
    _assert_same_tree(ted.convert_espnet_decoder(dec, ted.EspnetDecoderConfig(**dcfg), "decoder."),
                      jed.convert_espnet_decoder(dec, jed.EspnetDecoderConfig(**dcfg), "decoder."))
    lm = {"embed.weight": arr(14, 8), "decoder.weight": arr(14, 16), "decoder.bias": arr(14),
          **{k.replace("encoder.embed.0.weight", "encoder.embed.0.weight"): v
             for k, v in enc.items() if "pos_bias" not in k}}
    lcfg = dict(n_vocab=14, embed_unit=8, att_unit=32, head=4, unit=48, layer=1)
    _assert_same_tree(tlm.convert_espnet_lm(lm, tlm.EspnetLMConfig(**lcfg)),
                      jlm.convert_espnet_lm(lm, jlm.EspnetLMConfig(**lcfg)))
    head = {"fc1.weight": arr(8, 4), "fc1.bias": arr(8), "fc2.weight": arr(3, 8),
            "fc2.bias": arr(3), **{f"bn1.{k}": arr(8) for k in bn}}
    _assert_same_tree(tavsr.convert_mlp_head(head), javsr.convert_mlp_head(head))


def test_random_trees_have_the_shapes_encode_reads():
    """`init_*` draw trees at any config that the port's functions run, and
    hold the same leaves as the JAX package's test builders."""
    gen = torch.Generator().manual_seed(0)
    jcfg, tcfg = cfgs(**ENC_CFGS["conformer"])
    tree = traven.init_encoder(tcfg, gen, dtype=torch.float32)
    want = to_np(_enc_params(jcfg))
    want["embed"]["norm"] = {"weight": np.zeros(32), "bias": np.zeros(32)}
    assert sorted(k for k, _ in _flat(tree)) == sorted(k for k, _ in _flat(want))
    front = traven.init_conv3d_frontend(gen, widths=(8, 8, 16, 16, 32))
    feats = traven.conv3d_frontend(front, torch.zeros(1, 1, 3, 24, 24))
    out = traven.encode(tree, tcfg, torch.randn(1, 3, 16, generator=gen))
    assert feats.shape == (1, 3, 32) and out.shape == (1, 3, 32)
    assert torch.isfinite(out).all()
    dec = ted.init_decoder(ted.EspnetDecoderConfig(odim=14, attention_dim=16, attention_heads=2,
                                                   linear_units=32, num_blocks=2), gen)
    assert sorted(k for k, _ in _flat(dec)) == sorted(k for k, _ in _flat(decoder_tree(0)))
    lm = tlm.init_lm(tlm.EspnetLMConfig(n_vocab=14, embed_unit=8, att_unit=16, head=2, unit=32,
                                        layer=1), gen)
    assert tlm.lm_logprobs(lm, tlm.EspnetLMConfig(n_vocab=14, embed_unit=8, att_unit=16, head=2,
                                                  unit=32, layer=1),
                           torch.zeros(2, 3, dtype=torch.long)).shape == (2, 14)
    a_front = tavsr.init_conv1d_frontend(gen, widths=(8, 8, 16, 16, 32))
    assert tavsr.conv1d_frontend(a_front, torch.randn(1, 1280, generator=gen)).shape == (1, 2, 32)
    head = tavsr.init_mlp_head(64, 24, 32, gen)
    assert tavsr.mlp_head(head, torch.randn(1, 3, 64, generator=gen)).shape == (1, 3, 32)
