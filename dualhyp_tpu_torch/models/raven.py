"""RAVEn/BRAVEn visual encoder (ESPnet conformer/transformer).

Counterpart of `dualhyp_tpu/models/raven.py` (ref: data/raven/espnet/nets/
pytorch_backend/...): the Conv3D + ResNet-18 mouth-ROI frontend
(backbones/conv3d_extractor.py, backbones/modules/resnet.py) feeding a
transformer or conformer encoder with

  * a linear input layer: Linear -> LayerNorm -> ReLU -> positions
    (encoder.py:142-149), or a bare Linear (auto_avsr);
  * absolute sinusoidal positions (times sqrt(d), embedding.py:44-87) or
    Transformer-XL relative positions (pe over [-(T-1), T-1],
    embedding.py:153-218), and the legacy reversed table;
  * MHA or rel-MHA with learned pos_bias_u/v and the rel-shift
    (attention.py:194-280);
  * the optional macaron feed-forward (times 0.5) and the conformer
    convolution module (pointwise-GLU -> depthwise -> BN -> swish ->
    pointwise, convolution.py:14-76), with the final LayerNorm
    (encoder_layer.py:83-128).

Inference only: dropout is off and each BatchNorm applies its running
statistics. The parameters are the JAX package's tree as torch tensors
(`ckpt.convert.raven_from_jax`, or `init_encoder` / `init_conv3d_frontend`
from a `torch.Generator`): per-layer dicts under `layers` keyed "0", "1",
..., weights in torch's (out, in) layout.

The compute dtype is the input's: the callers cast the video to
`encode_dtype` of the tree (bf16 for a bf16 checkpoint, fp32 otherwise) and
every weight is cast to the activation's dtype at use. These run in fp32
whatever that dtype, as in the JAX package: the attention scores and
softmax, LayerNorm and BatchNorm. The plain PyTorch ops here are what the
JAX package leaves to XLA; no TPU kernel lies on this path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dualhyp_tpu_torch.device import to_device
from dualhyp_tpu_torch.models.whisper import f32_product
from dualhyp_tpu_torch.ops.swiglu import linear


def swish(x):
    return x * torch.sigmoid(x)


@dataclass(frozen=True)
class RavenEncoderConfig:
    idim: int = 512              # frontend output dim
    attention_dim: int = 1024    # BRAVEn-large
    attention_heads: int = 16
    linear_units: int = 4096
    num_blocks: int = 24
    attn_layer_type: str = "rel_mha"   # "mha" | "rel_mha" | "legacy_rel_mha"
    macaron_style: bool = False
    use_cnn_module: bool = False
    cnn_module_kernel: int = 31
    layerscale: bool = False
    normalize_before: bool = True


BRAVEN_LARGE = RavenEncoderConfig()
AUTO_AVSR_CONFORMER = RavenEncoderConfig(
    attention_dim=768,
    attention_heads=12,
    linear_units=3072,
    num_blocks=12,
    macaron_style=True,
    use_cnn_module=True,
)


def first_leaf_dtype(tree: dict) -> torch.dtype:
    """The dtype of the tree's first leaf in sorted key order (the JAX
    package's `tree_leaves(params)[0].dtype`)."""
    node = tree
    while isinstance(node, dict):
        node = node[sorted(node)[0]]
    return node.dtype


def encode_dtype(params: dict) -> torch.dtype:
    """Compute dtype of the frozen VSR/AVSR encode paths: the checkpoint's
    (`raven.encode_dtype` of the JAX package, without its A/B override)."""
    dtype = first_leaf_dtype(params)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the encoder computes in fp32 or bf16, not {dtype}")
    return dtype


# ---------------------------------------------------------------------------
# batch norm (inference: y = (x - mean) / sqrt(var + eps) * gamma + beta)
# ---------------------------------------------------------------------------

def _bn(leaf: dict, x, axis: int, eps: float = 1e-5):
    """In fp32 whatever the activation's and the statistics' dtype, cast
    back to x's dtype."""
    shape = [1] * x.dim()
    shape[axis] = -1

    def stat(name):
        return leaf[name].float().reshape(shape)

    y = (x.float() - stat("running_mean")) * stat("weight") * torch.rsqrt(
        stat("running_var") + eps) + stat("bias")
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Conv3D + ResNet-18 frontend (ref: conv3d_extractor.py, resnet.py)
# ---------------------------------------------------------------------------

def conv3d_frontend(params: dict, video):
    """video: (B, 1, T, H, W) normalised mouth ROI -> (B, T, 512)."""
    x = video
    # Conv3d(1->64, k=(5,7,7), s=(1,2,2), p=(2,3,3), no bias) + BN3d + swish
    x = F.conv3d(x, params["conv3d"]["weight"].to(x.dtype), stride=(1, 2, 2),
                 padding=(2, 3, 3))
    x = swish(_bn(params["bn3d"], x, axis=1))
    # MaxPool3d(k=(1,3,3), s=(1,2,2), p=(0,1,1))
    x = F.max_pool3d(x, kernel_size=(1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
    # fold time into batch for the 2D trunk (ref: threeD_to_2D_tensor)
    b, c, t, h, w = x.shape
    x = x.transpose(1, 2).reshape(b * t, c, h, w)
    x = _resnet18(params["resnet"], x)
    return x.reshape(b, t, -1)


def _conv2d(w, x, stride: int):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=1 if w.shape[-1] == 3 else 0)


def _basic_block(leaf: dict, x, stride: int):
    residual = x
    out = _conv2d(leaf["conv1"]["weight"], x, stride)
    out = swish(_bn(leaf["bn1"], out, axis=1))
    out = _conv2d(leaf["conv2"]["weight"], out, 1)
    out = _bn(leaf["bn2"], out, axis=1)
    if "downsample" in leaf:
        residual = _bn(leaf["downsample"]["bn"],
                       _conv2d(leaf["downsample"]["conv"]["weight"], x, stride), axis=1)
    return swish(out + residual)


def _resnet18(params: dict, x):
    for li, stride in enumerate((1, 2, 2, 2)):
        layer = params[f"layer{li + 1}"]
        x = _basic_block(layer["0"], x, stride)
        x = _basic_block(layer["1"], x, 1)
    return x.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)


# ---------------------------------------------------------------------------
# positional encodings (host numpy, the JAX package's tables)
# ---------------------------------------------------------------------------

def _div(d: int) -> np.ndarray:
    return np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10000.0) / d))


def abs_positions(t: int, d: int) -> np.ndarray:
    pe = np.zeros((t, d), np.float32)
    position = np.arange(t, dtype=np.float32)[:, None]
    pe[:, 0::2] = np.sin(position * _div(d))
    pe[:, 1::2] = np.cos(position * _div(d))
    return pe


def legacy_rel_positions(t: int, d: int, max_len: int = 5000) -> np.ndarray:
    """The first T rows of a reversed max_len table: positions max_len-1 ..
    max_len-T (LegacyRelPositionalEncoding, reverse=True, 5000 cached)."""
    positions = np.arange(max_len - 1, max_len - 1 - t, -1, dtype=np.float32)[:, None]
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(positions * _div(d))
    pe[:, 1::2] = np.cos(positions * _div(d))
    return pe


def rel_positions(t: int, d: int) -> np.ndarray:
    """(2T-1, d): positive positions reversed, then the negatives
    (ref: embedding.py:172-218)."""
    position = np.arange(t, dtype=np.float32)[:, None]
    div = _div(d)
    pos = np.zeros((t, d), np.float32)
    neg = np.zeros((t, d), np.float32)
    pos[:, 0::2] = np.sin(position * div)
    pos[:, 1::2] = np.cos(position * div)
    neg[:, 0::2] = np.sin(-position * div)
    neg[:, 1::2] = np.cos(-position * div)
    return np.concatenate([pos[::-1], neg[1:]], axis=0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _linear(leaf: dict, x):
    return linear(x, leaf["weight"], leaf.get("bias"))


def _split_heads(x, h: int):
    b, t, d = x.shape
    return x.view(b, t, h, d // h).transpose(1, 2)


def _rel_shift(x):
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL shift
    (ref: attention.py:218-238)."""
    b, h, t1, t2 = x.shape
    padded = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1).view(b, h, t2 + 1, t1)
    return padded[:, :, 1:].reshape(b, h, t1, t2)[..., : t2 // 2 + 1]


def _legacy_rel_shift(x):
    """Old-style shift over a (B, H, T, T) matrix (ref: attention.py:133-150)."""
    b, h, t1, t2 = x.shape
    padded = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1).view(b, h, t2 + 1, t1)
    return padded[:, :, 1:].reshape(b, h, t1, t2)


def apply_mask(scores, mask, batch: int):
    """scores (B, H, T, S) with -inf where `mask` is False: a (B, S) padding
    mask when its first dimension is the batch size, else a (T, S) or a
    (B|1, T, S) attention mask (`raven._mha`'s rule)."""
    if mask is None:
        return scores
    if mask.dim() == 2 and mask.shape[0] == batch:
        keep = mask[:, None, None, :]
    elif mask.dim() == 2:
        keep = mask[None, None]
    else:
        keep = mask[:, None]
    return scores.masked_fill(~keep, float("-inf"))


def _mha(leaf: dict, x, n_head: int, pos_emb=None, mask=None, legacy=False):
    b, t, d = x.shape
    dk = d // n_head
    q = _split_heads(_linear(leaf["linear_q"], x), n_head)
    k = _split_heads(_linear(leaf["linear_k"], x), n_head)
    v = _split_heads(_linear(leaf["linear_v"], x), n_head)
    if pos_emb is not None:
        p = _split_heads(_linear(leaf["linear_pos"], pos_emb[None].to(x.dtype)), n_head)
        q_t = q.transpose(1, 2)  # (B, T, H, dk)
        q_u = (q_t + leaf["pos_bias_u"].to(x.dtype)).transpose(1, 2)
        q_v = (q_t + leaf["pos_bias_v"].to(x.dtype)).transpose(1, 2)
        matrix_ac = f32_product(q_u, k.transpose(-1, -2))
        matrix_bd = f32_product(q_v, p.expand(b, -1, -1, -1).transpose(-1, -2))
        shift = _legacy_rel_shift if legacy else _rel_shift
        scores = (matrix_ac + shift(matrix_bd)) / math.sqrt(dk)
    else:
        scores = f32_product(q, k.transpose(-1, -2)) / math.sqrt(dk)
    scores = apply_mask(scores, mask, b)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(w, v).transpose(1, 2).reshape(b, t, d)
    return _linear(leaf["linear_out"], out)


def _feed_forward(leaf: dict, x):
    return _linear(leaf["w_2"], torch.relu(_linear(leaf["w_1"], x)))


def _conv1d_bias(leaf: dict, h, padding: int = 0, groups: int = 1):
    """conv1d, then its bias added in h's dtype (the JAX package's order)."""
    out = F.conv1d(h, leaf["weight"].to(h.dtype), padding=padding, groups=groups)
    return out + leaf["bias"].to(h.dtype)[None, :, None]


def _conv_module(leaf: dict, x, mask_pad=None):
    """(ref: convolution.py:14-76). x: (B, T, D).

    `mask_pad` ((B, T) bool, True = real frame) zeroes padded positions
    right before the depthwise conv, the only op here that mixes time, so a
    right-zero-padded batch gives exactly the per-utterance outputs at real
    positions (the pointwise conv and GLU biases re-inject nonzero values
    at padded positions, so zeroing the module's input is not enough)."""
    h = x.transpose(1, 2)  # (B, D, T)
    h = _conv1d_bias(leaf["pointwise_cov1"], h)
    a, b = h.chunk(2, dim=1)
    h = a * torch.sigmoid(b)  # GLU over the channels
    if mask_pad is not None:
        h = h.masked_fill(~mask_pad[:, None, :], 0)
    k = leaf["depthwise_conv"]["weight"].shape[-1]
    h = _conv1d_bias(leaf["depthwise_conv"], h, padding=(k - 1) // 2, groups=h.shape[1])
    h = swish(_bn(leaf["norm"], h, axis=1))
    h = _conv1d_bias(leaf["pointwise_cov2"], h)
    return h.transpose(1, 2)


def _ln(leaf: dict, x):
    """LayerNorm with its statistics and affine map in fp32, rounded to x's
    dtype (`ops.rmsnorm.layer_norm` of the JAX package)."""
    return F.layer_norm(x.float(), x.shape[-1:], leaf["weight"].float(), leaf["bias"].float(),
                        1e-5).to(x.dtype)


def _encoder_layer(cfg: RavenEncoderConfig, leaf: dict, x, pos_emb, mask, mask_pad=None):
    if cfg.macaron_style:
        x = x + 0.5 * _feed_forward(leaf["feed_forward_macaron"],
                                    _ln(leaf["norm_ff_macaron"], x))
    x = x + _mha(leaf["self_attn"], _ln(leaf["norm_mha"], x), cfg.attention_heads,
                 pos_emb=pos_emb, mask=mask, legacy=cfg.attn_layer_type == "legacy_rel_mha")
    if cfg.use_cnn_module:
        x = x + _conv_module(leaf["conv_module"], _ln(leaf["norm_conv"], x), mask_pad=mask_pad)
    scale = 0.5 if cfg.macaron_style else 1.0
    x = x + scale * _feed_forward(leaf["feed_forward"], _ln(leaf["norm_ff"], x))
    if cfg.use_cnn_module and "norm_final" in leaf:
        x = _ln(leaf["norm_final"], x)
    return x


_INFER_MASK_PAD = object()


def encode(params: dict, cfg: RavenEncoderConfig, feats, mask=None, mask_pad=_INFER_MASK_PAD):
    """feats: (B, T, idim) frontend features -> (B, T, attention_dim), in
    feats' dtype.

    `mask` feeds attention ((B, S) padding, or a (T, S) / (B, T, S)
    attention mask); `mask_pad` is the (B, T) True-is-real padding mask the
    conformer conv module zeroes padded frames with. Left at the default it
    is inferred: `mask` when it is 2-D with the batch size first (the JAX
    package's rule, ambiguous for a square attention mask when B equals T:
    such callers pass a 3-D mask, as the LM does)."""
    x = _linear(params["embed"]["linear"], feats)
    if "norm" in params["embed"]:
        # raven's linear input layer: Linear -> LayerNorm -> ReLU; the
        # auto_avsr encoders embed with a bare Linear
        x = torch.relu(_ln(params["embed"]["norm"], x))
    t, d = x.shape[1], cfg.attention_dim
    x = x * math.sqrt(d)
    pos_emb = None
    if cfg.attn_layer_type in ("rel_mha", "legacy_rel_mha"):
        table = rel_positions if cfg.attn_layer_type == "rel_mha" else legacy_rel_positions
        pos_emb = to_device(table(t, d), x.device)
    else:
        x = x + to_device(abs_positions(t, d), x.device).to(x.dtype)
    if mask_pad is _INFER_MASK_PAD:
        mask_pad = mask if (mask is not None and mask.dim() == 2
                            and mask.shape[0] == x.shape[0]) else None
    for i in range(cfg.num_blocks):
        x = _encoder_layer(cfg, params["layers"][str(i)], x, pos_emb, mask, mask_pad=mask_pad)
    if "after_norm" in params:
        x = _ln(params["after_norm"], x)
    return x


# ---------------------------------------------------------------------------
# weight conversion from torch state_dicts
# ---------------------------------------------------------------------------

def _nest(state: dict, prefix: str) -> dict:
    out: dict = {}
    plen = len(prefix)
    for key, value in state.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[plen:].split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.as_tensor(np.asarray(value)) if not isinstance(
            value, torch.Tensor) else value
    return out


def convert_espnet_encoder(state: dict, cfg: RavenEncoderConfig, prefix: str = "") -> dict:
    """ESPnet Encoder state_dict -> the tree `encode` reads: the linear
    input layer (embed.0 Linear, embed.1 LayerNorm) and the layers."""
    tree = _nest(state, prefix)
    embed = tree["embed"]
    embed_leaves = {"linear": embed["0"]}
    if "1" in embed and "weight" in embed["1"]:
        embed_leaves["norm"] = embed["1"]  # raven's linear input layer only
    params = {"embed": embed_leaves,
              "layers": {str(i): tree["encoders"][str(i)] for i in range(cfg.num_blocks)}}
    if "after_norm" in tree:
        params["after_norm"] = tree["after_norm"]
    return params


def _resnet_blocks(layer: dict) -> dict:
    blocks = {}
    for bi, block in layer.items():
        leaf = {"conv1": block["conv1"], "bn1": block["bn1"],
                "conv2": block["conv2"], "bn2": block["bn2"]}
        if "downsample" in block:
            leaf["downsample"] = {"conv": block["downsample"]["0"],
                                  "bn": block["downsample"]["1"]}
        blocks[bi] = leaf
    return blocks


def convert_conv3d_frontend(state: dict, prefix: str = "") -> dict:
    """Conv3dResNet state_dict -> the tree `conv3d_frontend` reads
    (frontend3D.0 conv, .1 BN, trunk.layerN.M blocks)."""
    tree = _nest(state, prefix)
    fe, trunk = tree["frontend3D"], tree["trunk"]
    return {"conv3d": fe["0"], "bn3d": fe["1"],
            "resnet": {f"layer{li}": _resnet_blocks(trunk[f"layer{li}"]) for li in range(1, 5)}}


# ---------------------------------------------------------------------------
# random trees (seeded; the shapes the functions above read)
# ---------------------------------------------------------------------------

class Draw:
    """Random leaves from one `torch.Generator`, drawn on its device in fp32
    and put on `device` in `dtype`: weights normal with std 1/sqrt(fan in),
    biases small, LayerNorm and BatchNorm near identity."""

    def __init__(self, generator: torch.Generator, device=None, dtype=torch.float32):
        self.gen = generator
        self.device = generator.device if device is None else torch.device(device)
        self.dtype = dtype

    def normal(self, *shape, std=1.0):
        t = torch.randn(shape, generator=self.gen, device=self.gen.device) * std
        return t.to(self.device, self.dtype)

    def weight(self, *shape):
        return self.normal(*shape, std=1.0 / math.sqrt(math.prod(shape[1:])))

    def lin(self, out_f: int, in_f: int, bias: bool = True) -> dict:
        leaf = {"weight": self.weight(out_f, in_f)}
        if bias:
            leaf["bias"] = self.normal(out_f, std=0.02)
        return leaf

    def ln(self, d: int) -> dict:
        return {"weight": 1 + self.normal(d, std=0.02), "bias": self.normal(d, std=0.02)}

    def bn(self, d: int) -> dict:
        return {"running_mean": self.normal(d, std=0.1),
                "running_var": 1 + self.normal(d, std=0.1) ** 2,
                "weight": 1 + self.normal(d, std=0.02), "bias": self.normal(d, std=0.02)}


def init_encoder(cfg: RavenEncoderConfig, generator: torch.Generator, *, device=None,
                 dtype=torch.float32, embed_norm: bool = True) -> dict:
    """A random encoder tree at any config (raven's linear input layer with
    its LayerNorm, or the bare Linear of auto_avsr when not `embed_norm`)."""
    r = Draw(generator, device, dtype)
    d, h, lu = cfg.attention_dim, cfg.attention_heads, cfg.linear_units
    layers = {}
    for i in range(cfg.num_blocks):
        attn = {"linear_q": r.lin(d, d), "linear_k": r.lin(d, d), "linear_v": r.lin(d, d),
                "linear_out": r.lin(d, d)}
        if cfg.attn_layer_type in ("rel_mha", "legacy_rel_mha"):
            attn.update(linear_pos={"weight": r.weight(d, d)},
                        pos_bias_u=r.normal(h, d // h, std=0.02),
                        pos_bias_v=r.normal(h, d // h, std=0.02))
        leaf = {"norm_mha": r.ln(d), "self_attn": attn, "norm_ff": r.ln(d),
                "feed_forward": {"w_1": r.lin(lu, d), "w_2": r.lin(d, lu)}}
        if cfg.macaron_style:
            leaf["feed_forward_macaron"] = {"w_1": r.lin(lu, d), "w_2": r.lin(d, lu)}
            leaf["norm_ff_macaron"] = r.ln(d)
        if cfg.use_cnn_module:
            k = cfg.cnn_module_kernel
            leaf["conv_module"] = {
                "pointwise_cov1": {"weight": r.weight(2 * d, d, 1), "bias": r.normal(2 * d, std=0.02)},
                "depthwise_conv": {"weight": r.weight(d, 1, k), "bias": r.normal(d, std=0.02)},
                "norm": r.bn(d),
                "pointwise_cov2": {"weight": r.weight(d, d, 1), "bias": r.normal(d, std=0.02)}}
            leaf["norm_conv"] = r.ln(d)
            leaf["norm_final"] = r.ln(d)
        layers[str(i)] = leaf
    embed = {"linear": r.lin(d, cfg.idim)}
    if embed_norm:
        embed["norm"] = r.ln(d)
    return {"embed": embed, "layers": layers, "after_norm": r.ln(d)}


def init_conv3d_frontend(generator: torch.Generator, *, device=None, dtype=torch.float32,
                         widths=(64, 64, 128, 256, 512)) -> dict:
    """A random Conv3D + ResNet-18 tree: the stem's width, then the four
    stages' (the published model's by default)."""
    r = Draw(generator, device, dtype)
    stem = widths[0]

    def block(cin, cout, downsample):
        leaf = {"conv1": {"weight": r.weight(cout, cin, 3, 3)}, "bn1": r.bn(cout),
                "conv2": {"weight": r.weight(cout, cout, 3, 3)}, "bn2": r.bn(cout)}
        if downsample:
            leaf["downsample"] = {"conv": {"weight": r.weight(cout, cin, 1, 1)}, "bn": r.bn(cout)}
        return leaf

    resnet = {}
    cin = stem
    for li, cout in enumerate(widths[1:]):
        resnet[f"layer{li + 1}"] = {"0": block(cin, cout, li > 0 or cin != cout),
                                    "1": block(cout, cout, False)}
        cin = cout
    return {"conv3d": {"weight": r.weight(stem, 1, 5, 7, 7)}, "bn3d": r.bn(stem),
            "resnet": resnet}
