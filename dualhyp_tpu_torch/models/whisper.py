"""Whisper audio front-end and encoder.

Counterpart of `dualhyp_tpu/models/whisper.py`:

  * log-mel spectrogram: numpy on the host, a copy of the JAX package's
    (hann-window STFT, N_FFT 400, HOP 160, centred reflect padding, the last
    frame dropped; slaney mel filters; log10 clamp, max-8 floor, (x+4)/4);
  * the encoder: gelu(conv1) -> gelu(conv2, stride 2), both exact GELU ->
    + sinusoidal positions truncated to the frame count -> pre-LN blocks
    (LayerNorm statistics in fp32) -> final LayerNorm. The self-attention is
    `ops.flash_fwd.full_attention_fwd`: kernel K6 on a CUDA tensor, its plain
    version on a CPU tensor;
  * the text decoder (below `WhisperDecoderConfig`): the full forward
    (`decode_logits`, `decode_logits_with_cross_qk`), the cross-attention
    K/V of an utterance (`precompute_cross_kv`, float or int8), the causal
    prefill of a prompt (`prefill_cache`) and the cached one-token step
    (`decode_step_cached`) the beam searches run. Its linears are plain
    products, or int8 (`ops.quant.qmatmul`) or int4 (kernel K8,
    `ops.quant.q4matmul`) where `ops.quant.quantize_tree` replaced a weight;
    its attention and the vocabulary projection are plain PyTorch, as the
    JAX package leaves them to XLA.

The parameters are the JAX package's tree as torch tensors (`init_encoder`,
`ckpt.convert.encoder_from_jax`, `cli.make_json_asr.load_whisper`): per-layer
leaves stacked on axis 0 under `blocks`, weights in torch's (out, in) layout.

`encode` computes in fp32 by default, as the JAX package does, and its
products and convolutions then run in real fp32: TF32 is off while it runs
(`exact_fp32`), restored after, so nothing else in the process changes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dualhyp_tpu_torch.device import exact_fp32
from dualhyp_tpu_torch.ops import quant
from dualhyp_tpu_torch.ops.flash_fwd import full_attention_fwd
from dualhyp_tpu_torch.ops.rmsnorm import layer_norm
from dualhyp_tpu_torch.ops.swiglu import linear

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE


@dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 128        # large-v3; 80 for earlier checkpoints
    n_ctx: int = 1500
    n_state: int = 1280      # large
    n_head: int = 20
    n_layer: int = 32


WHISPER_LARGE_V3 = WhisperEncoderConfig()
WHISPER_TINY = WhisperEncoderConfig(n_mels=80, n_state=384, n_head=6, n_layer=4)


# ---------------------------------------------------------------------------
# mel front-end (numpy, host side: a copy of the JAX package's)
# ---------------------------------------------------------------------------

def _hz_to_mel_slaney(freq):
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz_slaney(mels):
    f_sp = 200.0 / 3
    freqs = mels * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )


def mel_filterbank(n_mels: int, n_fft: int = N_FFT, sr: int = SAMPLE_RATE
                   ) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filters (librosa's
    filters.mel)."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_min = _hz_to_mel_slaney(np.asarray(0.0))
    mel_max = _hz_to_mel_slaney(np.asarray(sr / 2.0))
    mel_points = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_points = _mel_to_hz_slaney(mel_points)

    fdiff = np.diff(hz_points)
    ramps = hz_points[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # slaney normalisation: equal area per filter
    enorm = 2.0 / (hz_points[2 : n_mels + 2] - hz_points[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def _stft_magnitudes(audio: np.ndarray) -> np.ndarray:
    """|STFT|^2 as torch.stft(center=True, pad_mode='reflect') gives it,
    dropping the final frame."""
    pad = N_FFT // 2
    padded = np.pad(audio, pad, mode="reflect")
    n_frames = 1 + (len(padded) - N_FFT) // HOP_LENGTH
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    strides = (padded.strides[0] * HOP_LENGTH, padded.strides[0])
    frames = np.lib.stride_tricks.as_strided(
        padded, shape=(n_frames, N_FFT), strides=strides
    )
    spec = np.fft.rfft(frames * window, axis=-1)
    mags = np.abs(spec[:-1]) ** 2  # drop the last frame
    return mags.astype(np.float32).T  # (n_freq, frames)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = 128) -> np.ndarray:
    """(n_mels, n_frames) log-mel features."""
    mags = _stft_magnitudes(np.asarray(audio, np.float32))
    mel = mel_filterbank(n_mels) @ mags
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    if audio.shape[-1] > length:
        return audio[..., :length]
    if audio.shape[-1] < length:
        width = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
        return np.pad(audio, width)
    return audio


def sinusoid_positions(length: int, channels: int, max_timescale=10000) -> np.ndarray:
    inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def init_encoder(cfg: WhisperEncoderConfig, generator: torch.Generator, *,
                 device=None, dtype=torch.float32) -> dict:
    """Random encoder weights with the JAX package's distributions
    (`init_encoder`): normal weights of std 1/sqrt(n_state), zero biases,
    unit LayerNorm scales. Drawn in fp32 from `generator` on its device."""
    s, n = cfg.n_state, cfg.n_layer
    std = 1.0 / math.sqrt(s)
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=gdev) * std).to(device, dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def lin(out_f, in_f, bias=True):
        leaf = {"weight": normal(n, out_f, in_f)}
        if bias:
            leaf["bias"] = zeros(n, out_f)
        return leaf

    return {
        "conv1": {"weight": normal(s, cfg.n_mels, 3), "bias": zeros(s)},
        "conv2": {"weight": normal(s, s, 3), "bias": zeros(s)},
        "blocks": {
            "attn_ln": {"scale": ones(n, s), "bias": zeros(n, s)},
            "attn": {"query": lin(s, s), "key": lin(s, s, bias=False),
                     "value": lin(s, s), "out": lin(s, s)},
            "mlp_ln": {"scale": ones(n, s), "bias": zeros(n, s)},
            "mlp": {"fc1": lin(4 * s, s), "fc2": lin(s, 4 * s)},
        },
        "ln_post": {"scale": ones(s), "bias": zeros(s)},
    }


def params_dtype(tree: dict) -> torch.dtype:
    """The dtype of a Whisper tree's first float leaf (its compute dtype; a
    quantized decoder keeps its embeddings in it)."""
    for value in tree.values():
        if isinstance(value, dict):
            return params_dtype(value)
        if value.is_floating_point():
            return value.dtype
    raise ValueError("no float leaf")


def _layer(tree: dict, i: int) -> dict:
    """Layer i of a tree of stacked leaves (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _linear(leaf: dict, x):
    return linear(x, leaf["weight"], leaf.get("bias"))


def _mha(leaf: dict, x, n_head: int):
    """Self-attention over (B, T, S): the heads are (B, H, T, 64) views of the
    projections, and K6's output a view of a (B, T, H, 64) buffer."""
    b, t, s = x.shape
    hd = s // n_head
    q, k, v = (_linear(leaf[name], x).view(b, t, n_head, hd).transpose(1, 2)
               for name in ("query", "key", "value"))
    out = full_attention_fwd(q, k, v, scale=hd ** -0.5)
    return _linear(leaf["out"], out.transpose(1, 2).reshape(b, t, s))


def _conv1d(leaf: dict, x, stride: int):
    return F.conv1d(x, leaf["weight"].to(x.dtype), leaf["bias"].to(x.dtype),
                    stride=stride, padding=1)


def encode(params: dict, cfg: WhisperEncoderConfig, mel, compute_dtype=torch.float32):
    """mel: (B, n_mels, T_frames) -> (B, ceil(T/2), n_state) features."""
    with torch.no_grad(), exact_fp32():
        x = mel.to(compute_dtype)
        x = F.gelu(_conv1d(params["conv1"], x, 1))
        x = F.gelu(_conv1d(params["conv2"], x, 2))
        x = x.transpose(1, 2)  # (B, T, S)
        t = x.shape[1]
        pos = torch.from_numpy(sinusoid_positions(cfg.n_ctx, cfg.n_state)[:t])
        x = x + pos.to(x.device, compute_dtype)
        blocks = params["blocks"]
        for i in range(cfg.n_layer):
            leaf = _layer(blocks, i)
            h = layer_norm(x, leaf["attn_ln"]["scale"], leaf["attn_ln"]["bias"])
            x = x + _mha(leaf["attn"], h, cfg.n_head)
            n = layer_norm(x, leaf["mlp_ln"]["scale"], leaf["mlp_ln"]["bias"])
            x = x + _linear(leaf["mlp"]["fc2"], F.gelu(_linear(leaf["mlp"]["fc1"], n)))
        return layer_norm(x, params["ln_post"]["scale"], params["ln_post"]["bias"])


# ---------------------------------------------------------------------------
# text decoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WhisperDecoderConfig:
    n_vocab: int = 51866     # large-v3
    n_ctx: int = 448
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 32


WHISPER_LARGE_V3_DECODER = WhisperDecoderConfig()


def init_decoder(cfg: WhisperDecoderConfig, generator: torch.Generator, *,
                 device=None, dtype=torch.float32) -> dict:
    """Random decoder weights with the JAX package's distributions
    (`init_decoder`): normal weights of std 1/sqrt(n_state), positional
    embeddings of std 0.01, zero biases, unit LayerNorm scales. Drawn in
    fp32 from `generator` on its device."""
    s, n = cfg.n_state, cfg.n_layer
    std = 1.0 / math.sqrt(s)
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def normal(*shape, scale=std):
        return (torch.randn(shape, generator=generator, device=gdev) * scale).to(device, dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def lin(out_f, in_f, bias=True):
        leaf = {"weight": normal(n, out_f, in_f)}
        if bias:
            leaf["bias"] = zeros(n, out_f)
        return leaf

    def attn():
        return {"query": lin(s, s), "key": lin(s, s, bias=False), "value": lin(s, s),
                "out": lin(s, s)}

    def norm():
        return {"scale": ones(n, s), "bias": zeros(n, s)}

    return {
        "token_embedding": normal(cfg.n_vocab, s),
        "positional_embedding": normal(cfg.n_ctx, s, scale=0.01),
        "blocks": {"attn_ln": norm(), "attn": attn(), "cross_ln": norm(), "cross": attn(),
                   "mlp_ln": norm(), "mlp": {"fc1": lin(4 * s, s), "fc2": lin(s, 4 * s)}},
        "ln": {"scale": ones(s), "bias": zeros(s)},
    }


def _ln(x, leaf: dict):
    """LayerNorm with the statistics and the affine map in fp32, rounded to
    x's dtype (`ops.rmsnorm.layer_norm`'s arithmetic, one fused kernel)."""
    return F.layer_norm(x.float(), x.shape[-1:], leaf["scale"].float(), leaf["bias"].float(),
                        1e-5).to(x.dtype)


def _dec_linear(leaf: dict, x):
    """A decoder linear: the plain product, or int8 / int4 where
    `quantize_tree` replaced the weight; the bias is added after the product
    in x's dtype (`_linear` of the JAX package)."""
    if quant.Q_KEY in leaf:
        y = quant.qmatmul(x, leaf[quant.Q_KEY], leaf[quant.SCALE_KEY])
    elif quant.Q4_KEY in leaf:
        y = quant.q4matmul(x, leaf[quant.Q4_KEY], leaf[quant.SCALE4_KEY])
    else:
        return linear(x, leaf["weight"], leaf.get("bias"))
    if "bias" in leaf:
        y = y + leaf["bias"].to(x.dtype)
    return y


def f32_product(a, b):
    """a @ b (batched over equal leading dims) with an fp32 result from
    operands in their own dtype: the JAX package's
    `preferred_element_type=float32` products. bf16
    operands take one bf16 tensor-core product with fp32 accumulation and an
    fp32 output on the card (`torch.bmm(..., out_dtype=)`); on the CPU they
    are widened first, which is exact."""
    if a.dtype != b.dtype or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    if a.device.type == "cuda":  # the callers' batch dims are equal
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def _heads(t, n_head: int):
    """(B, T, n_state) -> (B, H, T, hd) view."""
    b, t_len, s = t.shape
    return t.view(b, t_len, n_head, s // n_head).transpose(1, 2)


def _merge_heads(t):
    """(B, H, T, hd) -> (B, T, H * hd)."""
    b, h, t_len, hd = t.shape
    return t.transpose(1, 2).reshape(b, t_len, h * hd)


def _mha_qkv(leaf: dict, q_in, kv_in, n_head: int, causal: bool = False):
    """The full forward's attention (`_mha_qkv` of the JAX package): q and k
    each times hd^-0.25 in the compute dtype, fp32 logits and softmax, the
    probabilities rounded to the compute dtype before the PV product."""
    hd = q_in.shape[-1] // n_head
    scale = hd ** -0.25
    q = _heads(_dec_linear(leaf["query"], q_in), n_head)
    k = _heads(_dec_linear(leaf["key"], kv_in), n_head)
    v = _heads(_dec_linear(leaf["value"], kv_in), n_head)
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    if causal:
        tq, tk = logits.shape[-2:]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(q_in.dtype)
    return _dec_linear(leaf["out"], _merge_heads(torch.matmul(w, v))), logits


def _mlp(leaf: dict, x):
    n = _ln(x, leaf["mlp_ln"])
    return _dec_linear(leaf["mlp"]["fc2"], F.gelu(_dec_linear(leaf["mlp"]["fc1"], n)))


def _full_forward(params: dict, cfg: WhisperDecoderConfig, tokens, audio_features,
                  compute_dtype, want_qk: bool):
    t = tokens.shape[1]
    x = params["token_embedding"][tokens].to(compute_dtype)
    x = x + params["positional_embedding"][:t].to(compute_dtype)
    xa = audio_features.to(compute_dtype)
    qks = []
    for i in range(cfg.n_layer):
        leaf = _layer(params["blocks"], i)
        n = _ln(x, leaf["attn_ln"])
        x = x + _mha_qkv(leaf["attn"], n, n, cfg.n_head, causal=True)[0]
        n = _ln(x, leaf["cross_ln"])
        out, qk = _mha_qkv(leaf["cross"], n, xa, cfg.n_head)
        x = x + out
        if want_qk:
            qks.append(qk)
        x = x + _mlp(leaf, x)
    x = _ln(x, params["ln"])
    logits = (x @ params["token_embedding"].to(x.dtype).t()).float()
    return logits, (torch.stack(qks) if want_qk else None)


def decode_logits(params: dict, cfg: WhisperDecoderConfig, tokens, audio_features,
                  compute_dtype=None):
    """Full (uncached) decoder forward: tokens (B, T) and encoder features
    (B, S, n_state) -> fp32 logits (B, T, n_vocab), positions from 0.
    compute_dtype: the parameters' (`params_dtype`) when None; the JAX
    package defaults to fp32, the same for an fp32 tree, while a bf16 tree
    under int4 must compute in bf16 on the card (K8 takes bf16 only)."""
    with torch.no_grad(), exact_fp32():
        return _full_forward(params, cfg, tokens, audio_features,
                             compute_dtype or params_dtype(params), False)[0]


def decode_logits_with_cross_qk(params: dict, cfg: WhisperDecoderConfig, tokens,
                                audio_features, compute_dtype=None):
    """`decode_logits` that also returns every layer's fp32 cross-attention
    logits (q hd^-0.25)(k hd^-0.25) before the softmax, (L, B, H, T, S): the
    word-timing alignment's input."""
    with torch.no_grad(), exact_fp32():
        return _full_forward(params, cfg, tokens, audio_features,
                             compute_dtype or params_dtype(params), True)


# ---- cached decoding: one-token steps against a self-attention cache and
# the cross-attention K/V computed once an utterance ----

def _q8(t, dim: int = -1):
    """The one int8 quantizer of the decoder's K/V (`ops.quant.q8_rows`)."""
    return quant.q8_rows(t, dim=dim)


def precompute_cross_kv(params: dict, cfg: WhisperDecoderConfig, audio_features,
                        quantize=None):
    """The cross-attention K/V of U utterances' features (U, S, n_state),
    once each: float (k, v), each (L, U, H, S, hd) with K times hd^-0.25,
    or with quantize="int8" (k_q, k_scale, v_q, v_scale): int8 (L, U, H, S,
    hd) and fp32 scales (L, U, H, hd), one per (layer, utterance, channel)
    over the frames. The JAX package keeps them (L, U, n_state, S); the
    values and the scales are the same. A beam row reads its utterance's
    K/V through a grouped product (`decode_step_cached`): no copy a row."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported cross-KV quantization: {quantize}")
    h = cfg.n_head
    scale = (cfg.n_state // h) ** -0.25
    out = [[] for _ in range(2 if quantize is None else 4)]
    with torch.no_grad(), exact_fp32():
        for i in range(cfg.n_layer):
            leaf = _layer(params["blocks"], i)["cross"]
            k = _heads(_dec_linear(leaf["key"], audio_features) * scale, h).contiguous()
            v = _heads(_dec_linear(leaf["value"], audio_features), h).contiguous()
            if quantize is None:
                out[0].append(k)
                out[1].append(v)
                continue
            # one layer's fp32 temporaries at a time
            for j, t in enumerate((k, v)):
                q, sc = _q8(t, dim=-2)
                out[2 * j].append(q.to(torch.int8))
                out[2 * j + 1].append(sc)
    return tuple(torch.stack(parts) for parts in out)


def init_self_cache(cfg: WhisperDecoderConfig, batch: int, max_len: int,
                    dtype=torch.float32, quantize=None, device=None) -> dict:
    """Self-attention cache (L, B, H, max_len, hd) for K (times hd^-0.25)
    and V: a row's heads each a contiguous run of columns, so its history
    enters the products as a view (the JAX package keeps (L, B, max_len,
    n_state)). quantize="int8" stores int8 values with fp32 scales
    "k_scale" / "v_scale" (L, B, max_len), one per (layer, row, column)."""
    hd = cfg.n_state // cfg.n_head
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, hd)
    if quantize is None:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if quantize != "int8":
        raise ValueError(f"unsupported self-KV quantization: {quantize}")
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:2] + (max_len,), dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:2] + (max_len,), dtype=torch.float32,
                                   device=device)}


def reparent(cache: dict, parents, n_cols: int) -> None:
    """Columns 0..n_cols-1 of row i become those of row parents[i], in
    place, for every layer: a beam's ancestors, re-parented by index."""
    if n_cols <= 0:
        return
    for key, t in cache.items():
        hist = t[:, :, :n_cols] if key.endswith("_scale") else t[:, :, :, :n_cols]
        hist.copy_(hist.index_select(1, parents))


def _cross_attention(q, k, v, k_scale=None, v_scale=None):
    """Rows against their utterance's memory: q (U, H, M, hd), the M query
    rows of each utterance (its beam rows times their positions); k, v (U,
    H, S, hd) float, K already times hd^-0.25, or int8 with fp32 (U, H, hd)
    scales. The K scale folds into q and the V scale into the output, so the
    int8 values enter the products as they are (exact in the compute
    dtype). Returns (U, H, M, hd) in q's dtype."""
    hd = q.shape[-1]
    dtype = q.dtype
    if k_scale is None:
        qf = q * hd ** -0.25
    else:
        qf = (q.float() * hd ** -0.25 * k_scale[:, :, None, :]).to(dtype)
        k, v = k.to(dtype), v.to(dtype)
    logits = f32_product(qf, k.transpose(-1, -2))
    w = torch.softmax(logits, dim=-1).to(dtype)
    att = torch.matmul(w, v)
    if v_scale is not None:
        att = (att.float() * v_scale[:, :, None, :]).to(dtype)
    return att


def _grouped_cross(leaf: dict, n, layer_kv: tuple, n_head: int):
    """Cross attention of (B, T, n_state) rows, B = U x R: row b reads
    utterance b // R's K/V."""
    b, t, s = n.shape
    k = layer_kv[0]
    u = k.shape[0]
    q = _dec_linear(leaf["query"], n).view(u, (b // u) * t, n_head, s // n_head).transpose(1, 2)
    if len(layer_kv) == 4:
        att = _cross_attention(q, layer_kv[0], layer_kv[2], layer_kv[1], layer_kv[3])
    else:
        att = _cross_attention(q, layer_kv[0], layer_kv[1])
    return _dec_linear(leaf["out"], att.transpose(1, 2).reshape(b, t, s))


def _positions(params: dict, pos, n_ctx: int, offsets=None):
    """Positional embeddings at `pos` (an int, or a tensor of columns, which
    the callers keep inside the table) less each row's `offsets`, clipped to
    the table: a row before its start reads position 0, and a position past
    n_ctx - 1 reads the last row (the JAX package's clip; the callers stop
    at n_ctx). Nothing is copied from the host."""
    pe = params["positional_embedding"]
    if offsets is None:
        return pe[min(max(pos, 0), n_ctx - 1)] if isinstance(pos, int) else pe[pos]
    idx = pos - offsets if isinstance(pos, int) else pos[None, :] - offsets[:, None]
    return pe[idx.clamp(0, n_ctx - 1)]


def decode_step_cached(params: dict, cfg: WhisperDecoderConfig, tokens, pos: int,
                       cache: dict, cross_kv: tuple, *, row_gather=None, pos_offset=None,
                       prefix_kv=None, prefix_valid=None, cache_pos=None):
    """One decoder step of B rows, all at column `pos` (an int: the rows
    advance in lockstep). tokens: (B,). Returns the fp32 logits (B, V); the
    cache is updated in place.

    cache: `init_self_cache`'s. The step writes its K/V at column `spos` =
    `cache_pos` (or `pos` when None) and attends to columns 0..spos.
    row_gather: (B,) rows' parents: before the write, columns 0..spos-1 of
    row i become those of row row_gather[i] (a beam's re-parenting, by
    index). An int8 cache quantizes the new column per row
    (`ops.quant.q8_rows`); its scales multiply the logits (K) and the
    probabilities (V), so the int8 values enter the products as they are.

    cross_kv: `precompute_cross_kv` of U utterances; row b reads utterance
    b // (B / U).

    prefix_kv: the prompt's K/V shared by an utterance's rows (`prefill_cache`
    laid out as the cross K/V: float (L, U, H, P, hd) pairs or the int8
    quadruple with (L, U, H, hd) scales); the cache then holds the new
    tokens only, indexed by `cache_pos`. The prompt's logits go before the
    cache's in one softmax. prefix_valid: (U, P) bool, each utterance's
    right-aligned prompt columns.

    pos_offset: (B,) ragged rows: row b's position is pos - pos_offset[b]
    (clipped at 0). Without a prefix, columns before a row's offset are
    masked, its own column always kept."""
    with torch.no_grad(), exact_fp32():
        return _decode_step(params, cfg, tokens, pos, cache, cross_kv, row_gather,
                            pos_offset, prefix_kv, prefix_valid, cache_pos)


def _decode_step(params, cfg, tokens, pos, cache, cross_kv, row_gather, pos_offset,
                 prefix_kv, prefix_valid, cache_pos):
    b = tokens.shape[0]
    h = cfg.n_head
    s = cfg.n_state
    hd = s // h
    scale = hd ** -0.25
    x = params["token_embedding"][tokens][:, None]
    pe = _positions(params, pos, cfg.n_ctx, pos_offset)
    x = x + (pe[:, None] if pe.dim() == 2 else pe)
    dtype = x.dtype
    spos = pos if cache_pos is None else cache_pos
    if row_gather is not None:
        reparent(cache, row_gather, spos)
    self_quant = cache["k"].dtype == torch.int8
    valid = None
    if cache_pos is None and pos_offset is not None:
        cols = torch.arange(spos + 1, device=x.device)
        valid = (cols[None, :] >= pos_offset[:, None]) | (cols[None, :] == spos)
    n_cross = len(cross_kv)
    u_pre = prefix_kv[0].shape[1] if prefix_kv is not None else 1
    for i in range(cfg.n_layer):
        leaf = _layer(params["blocks"], i)
        attn = leaf["attn"]
        n = _ln(x, leaf["attn_ln"])
        k_new = _dec_linear(attn["key"], n)[:, 0] * scale
        v_new = _dec_linear(attn["value"], n)[:, 0]
        q1 = _dec_linear(attn["query"], n).view(b, h, 1, hd)
        q = q1 * scale
        ck, cv = cache["k"][i], cache["v"][i]  # (B, H, T, hd)
        if self_quant:
            for new, vals, scales in ((k_new, ck, cache["k_scale"][i]),
                                      (v_new, cv, cache["v_scale"][i])):
                qv, sc = _q8(new)
                vals[:, :, spos] = qv.view(b, h, hd).to(torch.int8)
                scales[:, spos] = sc
        else:
            ck[:, :, spos] = k_new.view(b, h, hd).to(ck.dtype)
            cv[:, :, spos] = v_new.view(b, h, hd).to(cv.dtype)
        k_hist = ck[:, :, :spos + 1]
        v_hist = cv[:, :, :spos + 1]
        if self_quant:
            k_hist, v_hist = k_hist.to(dtype), v_hist.to(dtype)
        logits = f32_product(q, k_hist.transpose(-1, -2))  # (B, H, 1, T)
        if self_quant:
            logits = logits * cache["k_scale"][i][:, None, None, :spos + 1]
        if valid is not None:
            logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
        p_len = 0
        if prefix_kv is not None:
            pk = prefix_kv[0][i]
            p_len = pk.shape[2]
            if len(prefix_kv) == 4:
                qp = q1.view(u_pre, b // u_pre, h, hd).transpose(1, 2)  # (U, H, R, hd)
                qp = (qp.float() * scale * prefix_kv[1][i][:, :, None, :]).to(dtype)
                pk = pk.to(dtype)
            else:
                qp = q.view(u_pre, b // u_pre, h, hd).transpose(1, 2)
            pre = f32_product(qp, pk.transpose(-1, -2))  # (U, H, R, P)
            if prefix_valid is not None:
                pre = pre.masked_fill(~prefix_valid[:, None, None, :], float("-inf"))
            pre = pre.transpose(1, 2).reshape(b, h, 1, p_len)
            logits = torch.cat([pre, logits], dim=-1)
        w = torch.softmax(logits, dim=-1).to(dtype)
        w_pre, w = w[..., :p_len], w[..., p_len:]
        if self_quant:
            w = (w.float() * cache["v_scale"][i][:, None, None, :spos + 1]).to(dtype)
        att = torch.matmul(w, v_hist)  # (B, H, 1, hd)
        if prefix_kv is not None:
            pv = prefix_kv[2 if len(prefix_kv) == 4 else 1][i]
            wp = w_pre.reshape(u_pre, b // u_pre, h, p_len).transpose(1, 2)
            att_pre = torch.matmul(wp, pv.to(dtype))  # (U, H, R, hd)
            if len(prefix_kv) == 4:
                att_pre = (att_pre.float() * prefix_kv[3][i][:, :, None, :]).to(dtype)
            att = att + att_pre.transpose(1, 2).reshape(b, h, 1, hd)
        x = x + _dec_linear(attn["out"], att.reshape(b, 1, s))
        n = _ln(x, leaf["cross_ln"])
        x = x + _grouped_cross(leaf["cross"], n, tuple(c[i] for c in cross_kv[:n_cross]), h)
        x = x + _mlp(leaf, x)
    x = _ln(x, params["ln"])
    return (x[:, 0] @ params["token_embedding"].to(dtype).t()).float()


def prefill_cache(params: dict, cfg: WhisperDecoderConfig, tokens, cross_kv,
                  pos_offset=None):
    """One causal forward over a prompt's P columns: every layer's (K times
    hd^-0.25, V) at once, (L, B, P, n_state) each, as P `decode_step_cached`
    calls would write them (the same masks, positions and products).
    tokens: (B, P); pos_offset: (B,) ragged starts: column t sees columns
    offset..t and always itself, at position clip(t - offset, 0)."""
    with torch.no_grad(), exact_fp32():
        b, p = tokens.shape
        h = cfg.n_head
        s = cfg.n_state
        scale = (s // h) ** -0.25
        x = params["token_embedding"][tokens]
        cols = torch.arange(p, device=x.device)
        x = x + _positions(params, cols, cfg.n_ctx, pos_offset)
        mask = (cols[None] <= cols[:, None])[None]  # (1, q, k)
        if pos_offset is not None:
            mask = mask & ((cols[None, None] >= pos_offset[:, None, None])
                           | (cols[None] == cols[:, None])[None])
        ks, vs = [], []
        for i in range(cfg.n_layer):
            leaf = _layer(params["blocks"], i)
            attn = leaf["attn"]
            n = _ln(x, leaf["attn_ln"])
            k_full = _dec_linear(attn["key"], n) * scale
            v_full = _dec_linear(attn["value"], n)
            q = _dec_linear(attn["query"], n) * scale
            logits = f32_product(_heads(q, h), _heads(k_full, h).transpose(-1, -2))
            logits = logits.masked_fill(~mask[:, None], float("-inf"))
            w = torch.softmax(logits, dim=-1).to(x.dtype)
            x = x + _dec_linear(attn["out"], _merge_heads(torch.matmul(w, _heads(v_full, h))))
            n = _ln(x, leaf["cross_ln"])
            x = x + _grouped_cross(leaf["cross"], n, tuple(c[i] for c in cross_kv), h)
            x = x + _mlp(leaf, x)
            ks.append(k_full)
            vs.append(v_full)
        return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# weight conversion
# ---------------------------------------------------------------------------

def convert_hf_whisper_encoder(hf: dict, cfg: WhisperEncoderConfig) -> dict:
    """openai/whisper-* HF tensors ({name: tensor}) -> the encoder tree, per-layer
    leaves stacked on axis 0."""
    def get(name):
        for prefix in ("model.encoder.", "encoder.", ""):
            if prefix + name in hf:
                return hf[prefix + name]
        raise KeyError(name)

    def stack(fmt):
        return torch.stack([get(fmt.format(i)) for i in range(cfg.n_layer)])

    def lin(name, bias=True):
        leaf = {"weight": stack(f"layers.{{}}.{name}.weight")}
        if bias:
            leaf["bias"] = stack(f"layers.{{}}.{name}.bias")
        return leaf

    def norm(name):
        return {"scale": stack(f"layers.{{}}.{name}.weight"),
                "bias": stack(f"layers.{{}}.{name}.bias")}

    return {
        "conv1": {"weight": get("conv1.weight"), "bias": get("conv1.bias")},
        "conv2": {"weight": get("conv2.weight"), "bias": get("conv2.bias")},
        "blocks": {
            "attn_ln": norm("self_attn_layer_norm"),
            "attn": {"query": lin("self_attn.q_proj"),
                     "key": lin("self_attn.k_proj", bias=False),
                     "value": lin("self_attn.v_proj"),
                     "out": lin("self_attn.out_proj")},
            "mlp_ln": norm("final_layer_norm"),
            "mlp": {"fc1": lin("fc1"), "fc2": lin("fc2")},
        },
        "ln_post": {"scale": get("layer_norm.weight"), "bias": get("layer_norm.bias")},
    }


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


def convert_hf_whisper_decoder(hf: dict, cfg: WhisperDecoderConfig) -> dict:
    """openai/whisper-* HF tensors -> the decoder tree, per-layer leaves
    stacked on axis 0."""
    def get(name):
        for prefix in ("model.decoder.", "decoder.", ""):
            if prefix + name in hf:
                return _as_tensor(hf[prefix + name])
        raise KeyError(name)

    def stack(fmt):
        return torch.stack([get(fmt.format(i)) for i in range(cfg.n_layer)])

    def lin(name, bias=True):
        leaf = {"weight": stack(f"layers.{{}}.{name}.weight")}
        if bias:
            leaf["bias"] = stack(f"layers.{{}}.{name}.bias")
        return leaf

    def norm(name):
        return {"scale": stack(f"layers.{{}}.{name}.weight"),
                "bias": stack(f"layers.{{}}.{name}.bias")}

    def attn(prefix):
        return {"query": lin(f"{prefix}.q_proj"), "key": lin(f"{prefix}.k_proj", bias=False),
                "value": lin(f"{prefix}.v_proj"), "out": lin(f"{prefix}.out_proj")}

    return {
        "token_embedding": get("embed_tokens.weight"),
        "positional_embedding": get("embed_positions.weight"),
        "blocks": {
            "attn_ln": norm("self_attn_layer_norm"),
            "attn": attn("self_attn"),
            "cross_ln": norm("encoder_attn_layer_norm"),
            "cross": attn("encoder_attn"),
            "mlp_ln": norm("final_layer_norm"),
            "mlp": {"fc1": lin("fc1"), "fc2": lin("fc2")},
        },
        "ln": {"scale": get("layer_norm.weight"), "bias": get("layer_norm.bias")},
    }


def _openai_getter(sd: dict, prefixes: tuple):
    def get(name):
        for prefix in prefixes:
            if prefix + name in sd:
                return _as_tensor(sd[prefix + name])
        raise KeyError(name)
    return get


def _openai_blocks(get, n_layer: int, cross: bool) -> dict:
    def stack(fmt):
        return torch.stack([get(fmt.format(i)) for i in range(n_layer)])

    def lin(name, bias=True):
        leaf = {"weight": stack(name + ".weight")}
        if bias:
            leaf["bias"] = stack(name + ".bias")
        return leaf

    def ln(name):
        return {"scale": stack(name + ".weight"), "bias": stack(name + ".bias")}

    def attn(prefix):
        return {"query": lin(prefix + ".query"), "key": lin(prefix + ".key", bias=False),
                "value": lin(prefix + ".value"), "out": lin(prefix + ".out")}

    blocks = {"attn_ln": ln("blocks.{}.attn_ln"), "attn": attn("blocks.{}.attn")}
    if cross:
        blocks["cross_ln"] = ln("blocks.{}.cross_attn_ln")
        blocks["cross"] = attn("blocks.{}.cross_attn")
    blocks["mlp_ln"] = ln("blocks.{}.mlp_ln")
    blocks["mlp"] = {"fc1": lin("blocks.{}.mlp.0"), "fc2": lin("blocks.{}.mlp.2")}
    return blocks


def convert_openai_whisper_encoder(sd: dict, cfg: WhisperEncoderConfig) -> dict:
    """The OpenAI whisper checkpoint layout (`whisper.load_model`'s state
    dict) -> the encoder tree."""
    get = _openai_getter(sd, ("encoder.", "model.encoder.", ""))
    return {
        "conv1": {"weight": get("conv1.weight"), "bias": get("conv1.bias")},
        "conv2": {"weight": get("conv2.weight"), "bias": get("conv2.bias")},
        "blocks": _openai_blocks(get, cfg.n_layer, cross=False),
        "ln_post": {"scale": get("ln_post.weight"), "bias": get("ln_post.bias")},
    }


def convert_openai_whisper_decoder(sd: dict, cfg: WhisperDecoderConfig) -> dict:
    """The OpenAI whisper checkpoint layout -> the decoder tree."""
    get = _openai_getter(sd, ("decoder.", "model.decoder.", ""))
    return {
        "token_embedding": get("token_embedding.weight"),
        "positional_embedding": get("positional_embedding"),
        "blocks": _openai_blocks(get, cfg.n_layer, cross=True),
        "ln": {"scale": get("ln.weight"), "bias": get("ln.bias")},
    }
