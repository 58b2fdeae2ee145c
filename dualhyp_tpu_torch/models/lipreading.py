"""Lipreading trunks: ShuffleNetV2 and the temporal conv network (TCN).

Counterpart of `dualhyp_tpu/models/lipreading.py` (ref: ger/
lipreading_model.py:78-126, ger/lipreading_models/shufflenetv2.py, tcn.py):
the per-frame ShuffleNetV2 trunk and the multi-layer TCN with
symmetric-chomp dilated convolutions. No CLI runs them (RelPrompt uses the
BRAVEn encoder); they complete the reference's encoder surface. Inference
only: BatchNorms apply their running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dualhyp_tpu_torch.models.raven import _bn, _nest


def _conv2d(w, x, stride=1, pad=None, groups=1):
    if pad is None:
        pad = (w.shape[-1] - 1) // 2
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad, groups=groups)


def channel_shuffle(x, groups: int = 2):
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _conv_bn_relu(leaf: dict, x, stride=1, groups=1, relu=True, pad=None):
    out = _bn(leaf["bn"], _conv2d(leaf["conv"]["weight"], x, stride=stride, groups=groups,
                                  pad=pad), axis=1)
    return torch.relu(out) if relu else out


def inverted_residual(leaf: dict, x, stride: int, benchmodel: int):
    """(ref: shufflenetv2.py:51-113). benchmodel 1: split-half; 2: the
    stride-2 dual branch."""
    if benchmodel == 1:
        c = x.shape[1] // 2
        x1, x2 = x[:, :c], x[:, c:]
        h = _conv_bn_relu(leaf["b2_pw1"], x2)
        h = _conv_bn_relu(leaf["b2_dw"], h, stride=stride, groups=h.shape[1], relu=False)
        out = torch.cat([x1, _conv_bn_relu(leaf["b2_pw2"], h)], dim=1)
    else:
        a = _conv_bn_relu(leaf["b1_dw"], x, stride=stride, groups=x.shape[1], relu=False)
        a = _conv_bn_relu(leaf["b1_pw"], a)
        h = _conv_bn_relu(leaf["b2_pw1"], x)
        h = _conv_bn_relu(leaf["b2_dw"], h, stride=stride, groups=h.shape[1], relu=False)
        out = torch.cat([a, _conv_bn_relu(leaf["b2_pw2"], h)], dim=1)
    return channel_shuffle(out, 2)


def shufflenet_v2_trunk(params: dict, x):
    """The per-frame trunk: the stages of inverted residuals -> conv_last
    1x1 -> global pool. x: (N, C_in, H, W) -> (N, C_out)."""
    for block in params["features"]:
        x = inverted_residual(block["leaf"], x, block["stride"], block["benchmodel"])
    x = _conv_bn_relu(params["conv_last"], x, pad=0)
    return x.mean(dim=(2, 3))


def _conv1d(w, b, x, dilation=1, padding=0):
    out = F.conv1d(x, w.to(x.dtype), padding=padding, dilation=dilation)
    if b is not None:
        out = out + b.to(x.dtype)[None, :, None]
    return out


def _symm_chomp(x, chomp: int):
    """Remove `chomp` elements, split evenly between both ends (ref:
    tcn.py:21-34, Chomp1d with symm_chomp=True)."""
    half = chomp // 2
    return x[:, :, half:-half] if half else x


def temporal_block(leaf: dict, x, kernel_size: int, dilation: int):
    padding = (kernel_size - 1) * dilation
    h = _conv1d(leaf["conv1"]["weight"], leaf["conv1"].get("bias"), x, dilation, padding)
    h = torch.relu(_symm_chomp(_bn(leaf["batchnorm1"], h, axis=1), padding))
    h = _conv1d(leaf["conv2"]["weight"], leaf["conv2"].get("bias"), h, dilation, padding)
    h = torch.relu(_symm_chomp(_bn(leaf["batchnorm2"], h, axis=1), padding))
    res = x
    if "downsample" in leaf:
        res = _conv1d(leaf["downsample"]["weight"], leaf["downsample"].get("bias"), x)
    return torch.relu(h + res)


def temporal_conv_net(params: dict, x, kernel_size: int):
    """x: (B, T, C) -> (B, T, C_out). The dilation doubles a level."""
    h = x.transpose(1, 2)
    for i, leaf in enumerate(params["levels"]):
        h = temporal_block(leaf, h, kernel_size, 2 ** i)
    return h.transpose(1, 2)


def convert_shufflenet_trunk(state: dict, stage_repeats=(4, 8, 4)) -> dict:
    """ShuffleNetV2.features + conv_last state_dict -> our tree. Indices
    inside InvertedResidual: banch1 [0 dw conv, 1 bn, 2 pw conv, 3 bn];
    banch2 [0 pw, 1 bn, 3 dw, 4 bn, 5 pw, 6 bn]."""
    tree = _nest(state, "")
    features = []
    idx = 0
    for reps in stage_repeats:
        for rep in range(reps):
            node = tree["features"][str(idx)]
            b2 = node["banch2"]
            leaf = {"b2_pw1": {"conv": b2["0"], "bn": b2["1"]},
                    "b2_dw": {"conv": b2["3"], "bn": b2["4"]},
                    "b2_pw2": {"conv": b2["5"], "bn": b2["6"]}}
            if rep == 0:
                b1 = node["banch1"]
                leaf["b1_dw"] = {"conv": b1["0"], "bn": b1["1"]}
                leaf["b1_pw"] = {"conv": b1["2"], "bn": b1["3"]}
            features.append({"leaf": leaf, "stride": 2 if rep == 0 else 1,
                             "benchmodel": 2 if rep == 0 else 1})
            idx += 1
    conv_last = tree["conv_last"]
    return {"features": features, "conv_last": {"conv": conv_last["0"], "bn": conv_last["1"]}}


def convert_tcn(state: dict, num_levels: int) -> dict:
    tree = _nest(state, "network.")
    levels = []
    for i in range(num_levels):
        node = tree[str(i)]
        leaf = {k: node[k] for k in ("conv1", "batchnorm1", "conv2", "batchnorm2")}
        if "downsample" in node:
            leaf["downsample"] = node["downsample"]
        levels.append(leaf)
    return {"levels": levels}
