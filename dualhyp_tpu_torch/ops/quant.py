"""Int8 and int4 weight quantization for correction decoding.

Counterpart of `dualhyp_tpu/ops/quant.py`:

  * int8: symmetric per-output-row int8 weights with fp32 scales; the
    activation is quantized per row on the fly and the product accumulates
    int8 x int8 exactly in int32 (`qmatmul`);
  * int4: symmetric group-wise int4 (groups of 128 input columns), two
    values in [-7, 7] per byte, low nibble the even column; the product is
    kernel K8 (`ops/int4.q4_matmul`);
  * `q8_rows`: the one int8 quantizer of the decode KV cache.

The quantizers keep the JAX package's order of operations (`absmax / 127`,
then `w / scale`, rounding half to even), so the same numpy weights give
bit-identical codes, packed bytes and scales in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from dualhyp_tpu_torch.ops import int4

Q_KEY = "weight_q8"
SCALE_KEY = "weight_scale"
Q4_KEY = "weight_q4"
SCALE4_KEY = "weight_scale4"
INT4_GROUP = 128  # input columns per int4 scale
_MIN_QUANT_DIM = 256  # smaller matrices (norms, classifiers) stay as they are
# torch._int_mm (cuBLASLt int8) takes more than 16 rows
_INT_MM_MIN_ROWS = 32


def quantize_weight(w: torch.Tensor, absmax=None):
    """(out, in) float -> (int8 (out, in), fp32 scale (out, 1)).

    absmax: the rows' absmax (out, 1) in w's dtype, when w is a piece of
    longer rows (a row-parallel linear's weight); w's own when None."""
    if absmax is None:
        absmax = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_weight(q, scale, dtype=torch.float32):
    return q.to(dtype) * scale.to(dtype)


def _int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (n, k).T int8 -> (m, n) int32, exact."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ q.to(torch.int32).t()
    m, k = xq.shape
    if k % 8 or q.shape[0] % 8:
        raise ValueError(f"int8 product needs K and N multiples of 8, got {k}, {q.shape[0]}")
    if m < _INT_MM_MIN_ROWS:  # a decode batch: pad the rows, slice them back
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - m, k))])
    return torch._int_mm(xq.contiguous(), q.t())[:m]


def qmatmul(x, q, scale, x_absmax=None):
    """x (..., in) @ dequant(q).T with exact int8 x int8 -> int32 sums.

    The JAX package computes this product outside any Pallas kernel
    (`lax.dot_general` with an int32 result), so on the card it is the
    library's int8 GEMM (`torch._int_mm`); on the CPU an integer matmul.
    x_absmax: the rows' absmax that scales x (..., 1) fp32, when x is a
    piece of longer rows (a row-parallel linear's input); x's own when
    None."""
    x32 = x.to(torch.float32)
    if x_absmax is None:
        x_absmax = x32.abs().amax(dim=-1, keepdim=True)
    x_scale = torch.clamp(x_absmax, min=1e-8) / 127.0
    xq = torch.clamp(torch.round(x32 / x_scale), -127, 127).to(torch.int8)
    lead = xq.shape[:-1]
    acc = _int8_product(xq.reshape(-1, xq.shape[-1]), q).reshape(*lead, q.shape[0])
    out = acc.to(torch.float32) * x_scale * scale[..., 0]
    return out.to(x.dtype)


def q8_rows(t: torch.Tensor, dim: int = -1):
    """Symmetric round-to-nearest int8 quantization along `dim`: returns
    (int-valued fp32 in [-127, 127], fp32 scales with a 1e-12 floor). The
    prompt's K/V at prefill and each step's K/V round through it alike."""
    t = t.to(torch.float32)
    sc = torch.clamp(t.abs().amax(dim=dim) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(t / sc.unsqueeze(dim)), -127, 127)
    return q, sc


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP):
    """(out, in) float -> (packed int8 (out, in // 2), fp32 scale (out, in // group)).

    Two values in [-7, 7] per byte: the low nibble is the even column."""
    out_d, in_d = w.shape[-2:]
    if in_d % group or in_d % 2:
        raise ValueError(f"int4 needs in_features % {group} == 0, got {tuple(w.shape)}")
    lead = w.shape[:-2]
    wg = w.reshape(*lead, out_d, in_d // group, group)
    absmax = wg.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32)
    q = q.reshape(*lead, out_d, in_d)
    byte = (q[..., 0::2] & 0x0F) | ((q[..., 1::2] & 0x0F) << 4)
    packed = byte.to(torch.uint8).view(torch.int8)
    return packed, scale[..., 0].to(torch.float32)


def dequantize_weight_int4(packed, scale, dtype=torch.float32, group: int = INT4_GROUP):
    """Unpack and rescale to (out, in) in `dtype`."""
    lo, hi = int4.unpack_int4(packed)
    *lead, out_d, half = packed.shape
    q = torch.stack([lo, hi], dim=-1).reshape(*lead, out_d, half * 2)
    qg = q.reshape(*lead, out_d, (half * 2) // group, group).to(dtype)
    return (qg * scale[..., None].to(dtype)).reshape(*lead, out_d, half * 2)


def q4matmul(x, packed, scale, group: int = INT4_GROUP):
    """x (..., in) @ dequant4(packed).T: kernel K8 on the card, its plain
    version on the CPU (the Pallas kernel's arithmetic in both)."""
    return int4.q4_matmul(x, packed, scale, group=group)


def _should_quantize(key: str, leaf) -> bool:
    if key != "weight" or leaf.ndim < 2:
        return False
    return min(leaf.shape[-2:]) >= _MIN_QUANT_DIM


def quantize_pair(w: torch.Tensor, mode: str, absmax=None) -> dict:
    """The quantized leaves that replace weight `w` under `mode`: int4 where
    the input width is a multiple of the group, else int8 (as
    `quantize_tree` of the JAX package), with `absmax` as `quantize_weight`
    takes it."""
    if mode == "int4" and w.shape[-1] % INT4_GROUP == 0:
        q, s = quantize_weight_int4(w)
        return {Q4_KEY: q, SCALE4_KEY: s}
    q, s = quantize_weight(w, absmax)
    return {Q_KEY: q, SCALE_KEY: s}


def quantize_tree(params: dict, mode: str = "int8") -> dict:
    """Replace the big linear 'weight' leaves of a parameter tree (numpy
    arrays or torch tensors) with quantized pairs: mode "int8" per-row
    int8, "int4" group-wise int4 (lossy: validate WER before serving with
    it). Embedding tables ('wte') and small leaves stay as they are; a
    stacked (L, out, in) weight quantizes per (layer, row). Quantized leaves
    come back as torch tensors on the CPU."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantization mode {mode!r} not in ('int8', 'int4')")

    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, child in node.items():
            if (isinstance(child, (np.ndarray, torch.Tensor))
                    and _should_quantize(key, child) and name != "wte"):
                w = child if isinstance(child, torch.Tensor) else torch.from_numpy(np.array(child))
                out.update(quantize_pair(w, mode))
            else:
                out[key] = walk(child, key)
        return out

    return walk(params)


def is_quantized(leaves: dict) -> bool:
    return Q_KEY in leaves or Q4_KEY in leaves
