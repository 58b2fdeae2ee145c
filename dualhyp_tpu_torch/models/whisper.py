"""Whisper audio front-end and encoder.

Counterpart of the encoder half of `dualhyp_tpu/models/whisper.py` (the
text decoder is not ported yet):

  * log-mel spectrogram: numpy on the host, a copy of the JAX package's
    (hann-window STFT, N_FFT 400, HOP 160, centred reflect padding, the last
    frame dropped; slaney mel filters; log10 clamp, max-8 floor, (x+4)/4);
  * the encoder: gelu(conv1) -> gelu(conv2, stride 2), both exact GELU ->
    + sinusoidal positions truncated to the frame count -> pre-LN blocks
    (LayerNorm statistics in fp32) -> final LayerNorm. The self-attention is
    `ops.flash_fwd.full_attention_fwd`: kernel K6 on a CUDA tensor, its plain
    version on a CPU tensor.

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
