"""The port's Whisper encoder and K6/K7's plain versions against the JAX
package, on the CPU.

The log-mel front-end is the same numpy, so it is held to equality. The
encoder (fp32, the config of `tests/test_pallas.py`'s encoder test) is held
to 1e-5 against `encode` on the XLA path and on the Pallas path
(`DUALHYP_WHISPER_ATTN=flash`, K6 in interpret mode): fp32 sums in another
order through two blocks. K6's and K7's plain versions (`full_attention_plain`,
`causal_attention_fwd_plain`) are held against the Pallas kernels K6 and K7
in interpret mode: in fp32 to 1e-5; in bf16, where both keep the
probabilities in fp32 for the P V product and round the output once, at
most 1% of the elements may differ (a rounding of fp32 sums taken in
another order), by at most one bf16 ulp of the largest output. K1's plain
forward (`attention.causal_attention_plain`), which rounds the
probabilities to bf16, differs on ~40% of them. At an unaligned T the JAX
`causal_attention_fwd` takes its XLA path, which rounds the probabilities
too: there the plain version is held to 2 bf16 ulps of the largest output.
The safetensors reader reads a file written here with numpy, and
`load_whisper` gives the tree that the JAX package's
`convert_hf_whisper_encoder` gives on the same tensors, exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualhyp_tpu.models import whisper as jw
from dualhyp_tpu.ops.pallas import flash_fwd as jflash
from dualhyp_tpu_torch.ckpt.convert import encoder_from_jax
from dualhyp_tpu_torch.ckpt.io import load_safetensors
from dualhyp_tpu_torch.cli.make_json_asr import load_whisper
from dualhyp_tpu_torch.models import whisper as tw
from dualhyp_tpu_torch.ops import flash_fwd
from dualhyp_tpu_torch.ops.attention import causal_attention_plain

ATOL = 1e-5
# bf16 plain versions against the Pallas kernels: the share of elements that
# may differ, and the bound on a difference in bf16 ulps of the largest output
BF16_DIFFER_SHARE = 0.01
BF16_ULPS = 1
# against the XLA path at unaligned T, which rounds the probabilities to bf16
XLA_BF16_ULPS = 2
TINY = dict(n_mels=16, n_ctx=96, n_state=128, n_head=2, n_layer=2)


def _jax_encoder(seed=0, **kw):
    cfg = jw.WhisperEncoderConfig(**{**TINY, **kw})
    return cfg, jax.tree_util.tree_map(np.asarray, jw.init_encoder(cfg, jax.random.key(seed)))


def _port_cfg(cfg):
    return tw.WhisperEncoderConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_log_mel_front_end_is_the_jax_numpy(rng):
    audio = rng.normal(size=16000 * 2 + 37).astype(np.float32) * 0.1
    for n_mels in (80, 128):
        np.testing.assert_array_equal(tw.log_mel_spectrogram(audio, n_mels),
                                      jw.log_mel_spectrogram(audio, n_mels))
    np.testing.assert_array_equal(tw.pad_or_trim(audio), jw.pad_or_trim(audio))
    np.testing.assert_array_equal(tw.pad_or_trim(audio, 100), jw.pad_or_trim(audio, 100))
    np.testing.assert_array_equal(tw.sinusoid_positions(1500, 1280),
                                  jw.sinusoid_positions(1500, 1280))
    assert _port_cfg(jw.WHISPER_LARGE_V3) == tw.WHISPER_LARGE_V3
    assert _port_cfg(jw.WHISPER_TINY) == tw.WHISPER_TINY


@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("frames", [192, 77])
def test_encoder_matches_jax(rng, monkeypatch, attn, frames):
    cfg, params = _jax_encoder()
    mel = rng.normal(size=(2, 16, frames)).astype(np.float32)
    monkeypatch.setenv("DUALHYP_WHISPER_ATTN", attn)
    want = np.asarray(jw.encode(params, cfg, jnp.asarray(mel)))
    got = tw.encode(encoder_from_jax(params, device="cpu"), _port_cfg(cfg),
                    torch.from_numpy(mel))
    assert got.shape == want.shape == (2, (frames + 1) // 2, 128)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_encoder_init_has_the_jax_layout():
    cfg, params = _jax_encoder()
    ours = tw.init_encoder(_port_cfg(cfg), torch.Generator().manual_seed(0))
    flat = dict(_flat(ours))
    want = dict(_flat(params))
    assert sorted(flat) == sorted(want)
    for key, value in want.items():
        assert tuple(flat[key].shape) == value.shape, key


def _flat(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flat(value, path)
        else:
            yield path, value


# (280, 280): an utterance of the RelPrompt slice, the card kernel's main shape
@pytest.mark.parametrize("t,s", [(300, 300), (300, 170), (77, 300), (280, 280)])
def test_full_attention_plain_matches_the_pallas_kernel(rng, t, s):
    q = rng.normal(size=(2, 3, t, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 3, s, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jflash.full_attention_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    before = flash_fwd.FLASH_FULL.launches
    got = flash_fwd.full_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    assert flash_fwd.FLASH_FULL.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_full_attention_plain_masks_keys_past_kv_valid(rng):
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 40, 64)).astype(np.float32))
               for _ in range(3))
    got = flash_fwd.full_attention_plain(q, k, v, kv_valid=25)
    want = flash_fwd.full_attention_plain(q, k[:, :, :25], v[:, :, :25])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("t,hq,g", [(256, 4, 2), (48, 4, 4)])
def test_causal_attention_plain_matches_k7(rng, t, hq, g):
    """K7's plain version against `causal_attention_fwd`, the Pallas kernel
    in interpret mode (at T=48 with blocks of 48, at T=256 of 256)."""
    q = rng.normal(size=(1, hq, t, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, g, t, 64)).astype(np.float32) for _ in range(2))
    want = np.asarray(jflash.causal_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v)))
    got = flash_fwd.causal_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        got.numpy(),
        flash_fwd.causal_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v))).numpy())


def _bf16_inputs(seed, q_shape, kv_shape):
    """q, k, v drawn in fp32 with numpy, rounded to bf16: (JAX, torch)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=q_shape).astype(np.float32),
              *(rng.normal(size=kv_shape).astype(np.float32) for _ in range(2))]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _bf16_ulp_of_max(x):
    """One bf16 ulp (8 significant bits) of the largest |x|."""
    return float(np.exp2(np.floor(np.log2(np.abs(x).max())) - 7))


def _assert_bf16_close(got, want, share, ulps):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    differ = float((got != want).mean())
    worst = float(np.abs(got - want).max())
    assert differ <= share, f"{differ:.4f} of the elements differ (max {worst})"
    assert worst <= ulps * _bf16_ulp_of_max(want), f"max abs difference {worst}"


@pytest.mark.parametrize("t,s", [(256, 256), (256, 170), (77, 300)])
def test_full_attention_plain_matches_the_pallas_kernel_in_bf16(t, s):
    """K6's plain version against `full_attention_fwd` in interpret mode, at
    bf16 inputs: aligned T and S, and S != T (the kernel pads both and masks
    the keys past S)."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(t + s, (2, 3, t, 64), (2, 3, s, 64))
    want = jflash.full_attention_fwd(jq, jk, jv)
    got = flash_fwd.full_attention_fwd(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, want, BF16_DIFFER_SHARE, BF16_ULPS)


@pytest.mark.parametrize("t,hq,g", [(256, 4, 2), (256, 4, 4), (48, 4, 4)])
def test_causal_attention_plain_matches_k7_in_bf16(t, hq, g):
    """K7's plain version against `causal_attention_fwd` in interpret mode,
    at bf16 inputs. K1's plain forward, which rounds P to bf16 before P V
    (the arithmetic K7's plain version had before), misses the same bound."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(t + hq + g, (1, hq, t, 64), (1, g, t, 64))
    want = jflash.causal_attention_fwd(jq, jk, jv)
    _assert_bf16_close(flash_fwd.causal_attention_fwd(tq, tk, tv), want, BF16_DIFFER_SHARE,
                       BF16_ULPS)
    with pytest.raises(AssertionError, match="of the elements differ"):
        _assert_bf16_close(causal_attention_plain(tq, tk, tv), want, BF16_DIFFER_SHARE,
                           BF16_ULPS)


@pytest.mark.parametrize("t", [300, 768])
def test_causal_attention_plain_at_unaligned_t_matches_the_jax_xla_path_in_bf16(t):
    """At T=300 (not a multiple of the 256-row query block) and T=768 (not a
    multiple of the 512-key block) the JAX function runs
    `_causal_attention_xla`, which rounds the probabilities to bf16; the
    port keeps the Pallas arithmetic at every T (one bf16 ulp of the
    largest output measured, on ~40% of the elements)."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_inputs(t, (1, 4, t, 64), (1, 2, t, 64))
    want = jflash.causal_attention_fwd(jq, jk, jv)
    _assert_bf16_close(flash_fwd.causal_attention_fwd(tq, tk, tv), want, 1.0, XLA_BF16_ULPS)


# ---- safetensors files written here with numpy ----

_ST_NAMES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int64): "I64"}


def write_safetensors(path, tensors: dict, bf16=()) -> None:
    """{name: numpy array} as a safetensors file; names in `bf16` are fp32
    arrays stored as BF16 (their top 16 bits, truncated)."""
    header, blobs, offset = {}, [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if name in bf16:
            blob, dtype = (arr.astype(np.float32).view(np.uint32) >> 16).astype("<u2").tobytes(), "BF16"
        else:
            blob, dtype = arr.astype(arr.dtype.newbyteorder("<")).tobytes(), _ST_NAMES[arr.dtype]
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fp:
        fp.write(len(raw).to_bytes(8, "little"))
        fp.write(raw)
        for blob in blobs:
            fp.write(blob)


def test_safetensors_reader_reads_what_numpy_writes(tmp_path, rng):
    tensors = {"a.f32": rng.normal(size=(3, 5)).astype(np.float32),
               "b.f16": rng.normal(size=(7,)).astype(np.float16),
               "c.i64": np.arange(6, dtype=np.int64).reshape(2, 3),
               "d.bf16": rng.normal(size=(4, 2)).astype(np.float32),
               "e.empty": np.zeros((0, 3), np.float32)}
    write_safetensors(tmp_path / "x.safetensors", tensors, bf16=("d.bf16",))
    got = load_safetensors(tmp_path / "x.safetensors")
    assert sorted(got) == sorted(tensors)
    for name in ("a.f32", "b.f16", "c.i64", "e.empty"):
        assert got[name].numpy().dtype == tensors[name].dtype
        np.testing.assert_array_equal(got[name].numpy(), tensors[name])
    assert got["d.bf16"].dtype == torch.bfloat16
    truncated = (tensors["d.bf16"].view(np.uint32) & 0xFFFF0000).view(np.float32)
    np.testing.assert_array_equal(got["d.bf16"].float().numpy(), truncated)


def hf_encoder_tensors(params: dict, cfg) -> dict:
    """The JAX encoder tree as openai/whisper HF tensor names (the inverse of
    `convert_hf_whisper_encoder`)."""
    out = {"model.encoder.conv1.weight": params["conv1"]["weight"],
           "model.encoder.conv1.bias": params["conv1"]["bias"],
           "model.encoder.conv2.weight": params["conv2"]["weight"],
           "model.encoder.conv2.bias": params["conv2"]["bias"],
           "model.encoder.layer_norm.weight": params["ln_post"]["scale"],
           "model.encoder.layer_norm.bias": params["ln_post"]["bias"]}
    blocks = params["blocks"]
    names = {"self_attn.q_proj": blocks["attn"]["query"], "self_attn.k_proj": blocks["attn"]["key"],
             "self_attn.v_proj": blocks["attn"]["value"],
             "self_attn.out_proj": blocks["attn"]["out"],
             "fc1": blocks["mlp"]["fc1"], "fc2": blocks["mlp"]["fc2"],
             "self_attn_layer_norm": {"weight": blocks["attn_ln"]["scale"],
                                      "bias": blocks["attn_ln"]["bias"]},
             "final_layer_norm": {"weight": blocks["mlp_ln"]["scale"],
                                  "bias": blocks["mlp_ln"]["bias"]}}
    for i in range(cfg.n_layer):
        for name, leaf in names.items():
            for kind, value in leaf.items():
                out[f"model.encoder.layers.{i}.{name}.{kind}"] = np.asarray(value[i])
    return {k: np.asarray(v) for k, v in out.items()}


def write_whisper_checkpoint(path, params: dict, cfg, dtype=np.float32) -> None:
    """A HF Whisper directory: config.json + model.safetensors (encoder)."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "num_mel_bins": cfg.n_mels, "max_source_positions": cfg.n_ctx,
        "d_model": cfg.n_state, "encoder_attention_heads": cfg.n_head,
        "encoder_layers": cfg.n_layer}))
    write_safetensors(path / "model.safetensors",
                      {k: v.astype(dtype) for k, v in hf_encoder_tensors(params, cfg).items()})


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_load_whisper_matches_the_jax_conversion(tmp_path, rng, dtype):
    cfg, params = _jax_encoder(seed=1)
    write_whisper_checkpoint(tmp_path, params, cfg, dtype)
    (enc, enc_cfg), dec, tok = load_whisper(tmp_path, device="cpu")
    assert dec is None and tok is None
    assert enc_cfg == _port_cfg(cfg)
    hf = {k: v.astype(dtype) for k, v in hf_encoder_tensors(params, cfg).items()}
    want = dict(_flat(jw.convert_hf_whisper_encoder(hf, cfg)))
    got = dict(_flat(enc))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value.astype(np.float32), err_msg=key)
    mel = rng.normal(size=(1, 16, 60)).astype(np.float32)
    want_feats = np.asarray(jw.encode(jax.tree_util.tree_map(jnp.asarray, jw.convert_hf_whisper_encoder(hf, cfg)), cfg, jnp.asarray(mel)))
    got_feats = tw.encode(enc, enc_cfg, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got_feats, want_feats, rtol=0, atol=ATOL)


def test_load_whisper_refuses_the_decoder_and_tokenizer(tmp_path):
    """An encoder-only checkpoint has no decoder tensors and no
    tokenizer.json: asked for either, `load_whisper` raises (the decoder
    and the tokenizer are read since slice 6, tests/test_torch_asr_cli.py)."""
    cfg, params = _jax_encoder(seed=1)
    write_whisper_checkpoint(tmp_path, params, cfg)
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        load_whisper(tmp_path, device="cpu", need_tokenizer=True)
    with pytest.raises(KeyError):
        load_whisper(tmp_path, device="cpu", need_decoder=True)
