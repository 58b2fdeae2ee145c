"""Joint audio-visual (AVSR) encoder fusion, the auto_avsr model.

Counterpart of `dualhyp_tpu/models/avsr.py` (ref: data/auto_avsr/espnet/
nets/pytorch_backend/e2e_asr_conformer_av.py:23-116): two conformer
encoders (`models/raven`), the video stream from the Conv3D frontend and
the audio stream from the Conv1D-ResNet frontend (`conv1d_frontend`, 640
samples a frame at 16 kHz, the video's 25 fps), truncated to their common
length, concatenated on channels and fused by an MLP head to the decoder's
width; then the decoder, the CTC head and the joint beam shared with VSR.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dualhyp_tpu_torch.models.raven import (Draw, RavenEncoderConfig, _bn, _linear, _ln, _nest,
                                            _resnet_blocks, encode, swish)


def mlp_head(params: dict, x):
    """Linear -> BatchNorm1d | LayerNorm -> ReLU -> Linear (ref: auto_avsr
    MLPHead)."""
    h = _linear(params["fc1"], x)
    if "running_mean" in params["norm"]:
        h = _bn(params["norm"], h.transpose(1, 2), axis=1).transpose(1, 2)
    else:
        h = _ln(params["norm"], h)
    return _linear(params["fc2"], torch.relu(h))


def avsr_encode(params: dict, video_cfg: RavenEncoderConfig, audio_cfg: RavenEncoderConfig,
                video_feats, audio_feats, mask=None, *, video_mask=None, audio_mask=None):
    """Encode both streams, truncate to the common length, concatenate on
    channels, MLP-fuse to the decoder's width. `video_mask` / `audio_mask`
    give each stream its own (B, T) padding mask; both default to `mask`."""
    v = encode(params["video_encoder"], video_cfg, video_feats,
               video_mask if video_mask is not None else mask)
    a = encode(params["audio_encoder"], audio_cfg, audio_feats,
               audio_mask if audio_mask is not None else mask)
    t = min(v.shape[1], a.shape[1])
    return mlp_head(params["fusion"], torch.cat([v[:, :t], a[:, :t]], dim=-1))


def _conv1d(weight, x, stride: int, pad: int):
    return F.conv1d(x, weight.to(x.dtype), stride=stride, padding=pad)


def _mask_t(x, lengths):
    """Zero positions >= each row's length. x: (B, C, T); lengths: (B,)."""
    if lengths is None:
        return x
    keep = lengths[:, None] > torch.arange(x.shape[-1], device=x.device)[None, :]
    return x.masked_fill(~keep[:, None, :], 0)


def _res1d_block(leaf: dict, x, stride: int, lengths=None):
    """BasicBlock1D (ref: auto_avsr resnet1d.py:45-109): conv3(s) -> bn ->
    swish -> conv3 -> bn (+ the conv1x1/bn downsample residual), swish.
    `lengths` (each row's real positions) re-zeroes padded positions before
    every conv that mixes time, so a right-padded batch stays exact at real
    positions. Returns (out, out_lengths)."""
    out_len = None if lengths is None else (lengths - 1) // stride + 1
    residual = _mask_t(x, lengths)
    out = swish(_bn(leaf["bn1"], _conv1d(leaf["conv1"]["weight"], residual, stride, 1), axis=1))
    out = _mask_t(out, out_len)
    out = _bn(leaf["bn2"], _conv1d(leaf["conv2"]["weight"], out, 1, 1), axis=1)
    if "downsample" in leaf:
        residual = _bn(leaf["downsample"]["bn"],
                       _conv1d(leaf["downsample"]["conv"]["weight"], residual, stride, 0),
                       axis=1)
    return swish(out + residual), out_len


def conv1d_frontend(params: dict, audio, lengths=None):
    """The raw-waveform frontend, Conv1dResNet (ref: auto_avsr
    conv1d_extractor.py + resnet1d.py:111-215): conv(k=80, s=4, p=38) + BN +
    swish, four 2-block residual stages (strides 1/2/2/2), avgpool(20): one
    512-d frame per 640 samples. audio: (B, S) -> (B, S // 640, 512).
    `lengths` (each row's samples) keeps a right-zero-padded batch exact at
    each row's real frames."""
    s = audio.shape[-1] // 640 * 640
    x = audio[:, None, :s]
    cur = None if lengths is None else torch.clamp(lengths, max=s) // 640 * 640
    if cur is not None:
        x = _mask_t(x, cur)
        cur = (cur - 4) // 4 + 1  # conv1: k=80, s=4, p=38
    x = swish(_bn(params["bn1"], _conv1d(params["conv1"]["weight"], x, 4, 38), axis=1))
    for li in range(1, 5):
        blocks = params[f"layer{li}"]
        for bi in sorted(blocks, key=int):
            x, cur = _res1d_block(blocks[bi], x, (1 if li == 1 else 2) if bi == "0" else 1, cur)
    b, c, t = x.shape
    t_out = t // 20
    x = x[:, :, : t_out * 20].reshape(b, c, t_out, 20).mean(-1)  # AvgPool1d(20)
    return x.transpose(1, 2)


def convert_conv1d_frontend(state: dict, prefix: str = "") -> dict:
    """Conv1dResNet state_dict -> the tree `conv1d_frontend` reads
    (trunk.conv1/bn1, trunk.layerN.M.{conv1,bn1,conv2,bn2,downsample.0/1})."""
    trunk = _nest(state, prefix)["trunk"]
    params = {"conv1": trunk["conv1"], "bn1": trunk["bn1"]}
    for li in range(1, 5):
        params[f"layer{li}"] = _resnet_blocks(trunk[f"layer{li}"])
    return params


def convert_mlp_head(state: dict, prefix: str = "") -> dict:
    """MLPHead state_dict -> our tree (fc1, bn1|norm1, fc2) (ref: auto_avsr
    nets_utils.py:505-526)."""
    tree = _nest(state, prefix)
    return {"fc1": tree["fc1"], "norm": tree.get("bn1", tree.get("norm1")), "fc2": tree["fc2"]}


def init_conv1d_frontend(generator: torch.Generator, *, device=None, dtype=torch.float32,
                         widths=(64, 64, 128, 256, 512)) -> dict:
    """A random Conv1dResNet tree (the published widths by default)."""
    r = Draw(generator, device, dtype)

    def block(cin, cout, downsample):
        leaf = {"conv1": {"weight": r.weight(cout, cin, 3)}, "bn1": r.bn(cout),
                "conv2": {"weight": r.weight(cout, cout, 3)}, "bn2": r.bn(cout)}
        if downsample:
            leaf["downsample"] = {"conv": {"weight": r.weight(cout, cin, 1)}, "bn": r.bn(cout)}
        return leaf

    params = {"conv1": {"weight": r.weight(widths[0], 1, 80)}, "bn1": r.bn(widths[0])}
    cin = widths[0]
    for li, cout in enumerate(widths[1:]):
        params[f"layer{li + 1}"] = {"0": block(cin, cout, li > 0 or cin != cout),
                                    "1": block(cout, cout, False)}
        cin = cout
    return params


def init_mlp_head(d_in: int, hidden: int, d_out: int, generator: torch.Generator, *,
                  device=None, dtype=torch.float32, batch_norm: bool = True) -> dict:
    """A random fusion head (BatchNorm1d, or LayerNorm when not batch_norm)."""
    r = Draw(generator, device, dtype)
    return {"fc1": r.lin(hidden, d_in), "norm": r.bn(hidden) if batch_norm else r.ln(hidden),
            "fc2": r.lin(d_out, hidden)}
