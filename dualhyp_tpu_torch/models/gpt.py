"""Decoder-only GPT of the LLaMA and GPT-NeoX / Phi / Falcon families, with
the PEFT families of the JAX package: finetuning and decoding.

Counterpart of `dualhyp_tpu/models/gpt.py`: RMSNorm or LayerNorm (scale
and bias), the LLaMA (silu) or Gemma (tanh-gelu) gated MLP or the GPT-NeoX
MLP (`fc`, gelu exact or tanh, `proj`), optional biases on the linears and
on the head, grouped-query attention, full or partial rotary embeddings,
sequential or parallel residual with a separate or shared norm. PEFT:
  * LoRA on the fused QKV projection, on `proj`, on the MLP's linears
    (`lora_mlp`) and on the head (`lora_head`), gated by `lora_start_layer`;
  * LLaMA-Adapter v1 (`use_adapter`): a learned prefix of
    `adapter_prompt_length` rows a layer (`adapter_wte`) goes through the
    block's own QKV, unrotated, and the queries attend it with a full mask
    (fp32 logits, probabilities rounded to q's dtype); the result, gated
    per head by `gating_factor` and off below `adapter_start_layer`, adds
    to the causal attention output before `proj`. The prefix's K/V never
    enter the KV cache;
  * LLaMA-Adapter v2 (`use_adapter_v2`): fp32 `adapter_scale` and
    `adapter_bias` of length out_features on every linear, the head
    included, applied as (y + bias) * scale in y's dtype after the bias
    and the LoRA delta, on every path (plain, int8, int4 / K8, fused LoRA
    / K5).
A linear's bias is added after its product, in the product's dtype,
whether that product is plain, int8, int4 (K8) or the fused LoRA kernel
K5. The gated MLP runs K4 unless fc_1 has a bias, LoRA, the v2 wrap or a
quantized weight (the JAX package's rule): then three linears.

Layout decisions kept from the JAX package, so that its checkpoints load
with no re-layout and its parameter tree maps name for name onto this
module (`blocks.3.attn.qkv.lora_A` is leaf `blocks/attn/qkv/lora_A`[3]):
  * weights in torch's (out_features, in_features) layout;
  * the fused QKV output interleaved per query group as [q * q_per_kv, k, v];
  * its LoRA delta laid out as contiguous [q | k | v] blocks with a kv
    extent of n_embd // q_per_kv, added onto the interleaved output (the
    reference's own arithmetic, `lora_qkv_shapes`).

Where the JAX package runs one `lax.scan` over stacked layers, this module
loops over a `ModuleList` of blocks. The KV cache is a list of per-layer
(k, v) tensors of shape (B, G, S, D) in the compute dtype, updated in place.
Frozen matrices are stored in the compute dtype, norm scales in fp32 (a
trainer may round them to its frozen dtype). The PEFT leaves are fp32
masters, and a trainer in mode "full" makes every floating parameter one:
each is cast to the activation dtype where it is used, as the JAX package
casts its leaves (an AdamW step of ~1e-4 x lr would round away in bf16).

`forward` is the training and evaluation pass (grad enabled; LoRA-input
dropout from a generator; rematerialisation with `torch.utils.checkpoint`
of whole blocks, of the MLP alone, or of a block but its MoE up products:
the JAX package's `remat` True, "mlp" and "moe"); `prefill`,
`decode_step` and `verify_step` (K tokens a row in one pass, speculative
decoding's check of a draft) serve, without grad.
Every parameter is created with requires_grad False; a trainer turns it on
for `trainable_parameters(mode)`.

A RelPrompt config (`use_relprompt`) adds the two reliability classifiers
(`models/relprompt.NoiseClassifier`) and `n_extra_tokens` embedding rows
above `lm_head`'s vocabulary: the mask tokens are read, never emitted.

Decoding variants of the JAX package:
  * `quantize_model` replaces the big linear weights by int8 or int4 leaves
    (`weight_q8`/`weight_scale`, `weight_q4`/`weight_scale4`) and keeps
    the biases and adapter leaves beside them; a quantized MLP takes the
    unfused act(fc_1(x)) * fc_2(x) branch, so K4 does not run on it;
    `merge_lora` folds the LoRA deltas into the weights first;
  * `init_cache(..., quantize="int8")`: int8 K/V with fp32 per-slot scales;
  * `GPT(..., lora_impl="fused")`: the LoRA linears run kernel K5
    (`ops/lora`) instead of the composition (`DUALHYP_LORA_IMPL`, the JAX
    package's switch, when None; "xla", the composition, by default).

A Mixtral-style MoE config (`mlp_class="LLaMAMoE"`) puts an `MoE` in each
block where the dense configs have an `MLP`: a router and three
(E, out, in) expert stacks, top-`n_expert_per_token` routing.
`GPT(..., moe_impl=)` picks `_moe_mlp`'s dense einsums ("dense", the
default) or `_moe_mlp_sparse`'s sorted rows through the grouped matmul L2
(`ops/gmm`; "sparse" and "megablox", the JAX package's ragged_dot and
megablox gmm, which compute the same function), whose backward runs L2's
gradient kernels (drhs where the stacks train, mode "full"); None reads
`DUALHYP_MOE_IMPL`. LoRA stays on attention: the JAX expert stacks carry
none, and the JAX package cannot run a quantized MoE, so `quantize_model`
refuses one.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.models.relprompt import NoiseClassifier
from dualhyp_tpu_torch.ops import attention as attn_ops
from dualhyp_tpu_torch.ops import gmm as gmm_ops
from dualhyp_tpu_torch.ops import lora as lora_ops
from dualhyp_tpu_torch.ops import quant as quant_ops
from dualhyp_tpu_torch.ops import rmsnorm as norm_ops
from dualhyp_tpu_torch.ops import rope as rope_ops
from dualhyp_tpu_torch.ops import swiglu as mlp_ops
from dualhyp_tpu_torch.parallel import comm
from dualhyp_tpu_torch.parallel import sharding


NORM_CLASSES = ("RMSNorm", "LayerNorm")
MLP_CLASSES = ("LLaMAMLP", "GemmaMLP", "GptNeoxMLP", "LLaMAMoE")


def check_supported(cfg: GPTConfig) -> None:
    """Raise for a norm or MLP class this module does not know."""
    missing = []
    if cfg.norm_class not in NORM_CLASSES:
        missing.append(f"norm_class={cfg.norm_class}")
    if cfg.mlp_class not in MLP_CLASSES:
        missing.append(f"mlp_class={cfg.mlp_class}")
    if cfg.mlp_class == "LLaMAMoE" and not (cfg.n_expert > 0 and cfg.n_expert_per_token > 0):
        raise ValueError(f"config {cfg.name!r}: an MoE needs n_expert and n_expert_per_token")
    if missing:
        raise NotImplementedError(f"config {cfg.name!r} asks for {', '.join(missing)}")


# the training modes of the JAX package's `TrainConfig.mode`
MODES = ("lora", "adapter", "adapter_v2", "full")


def is_peft_leaf(name: str, cfg: GPTConfig) -> bool:
    """Whether the parameter `name` (a module path, `blocks.0.attn.qkv.
    lora_A`, or a tree path, `blocks/attn/qkv/lora_A`) trains outside mode
    "full": `trainable_mask` of the JAX package, by name. LoRA leaves;
    adapter v1's `adapter_wte` and `gating_factor`; adapter v2's
    `adapter_scale` and `adapter_bias` and every norm leaf (`norm_1`,
    `norm_2`, `ln_f`, LayerNorm biases too); RelPrompt's classifiers."""
    if "lora_A" in name or "lora_B" in name:
        return True
    if cfg.use_adapter and ("adapter_wte" in name or "gating_factor" in name):
        return True
    if cfg.use_adapter_v2 and ("adapter_scale" in name or "adapter_bias" in name
                               or "norm_1" in name or "norm_2" in name
                               or name.startswith("ln_f")):
        return True
    return "noise_classifier" in name or "audio_proj" in name or "visual_proj" in name


def lora_qkv_shapes(cfg: GPTConfig) -> tuple:
    """Output-row extents of the enabled q/k/v LoRA deltas (the reference's
    GQA arithmetic: the kv extent is n_embd // q_per_kv)."""
    kv_embd = cfg.n_embd // cfg.q_per_kv
    shapes = (
        cfg.n_embd * cfg.lora_query,
        kv_embd * cfg.lora_key,
        kv_embd * cfg.lora_value,
    )
    return tuple(s for s in shapes if s)


def lora_qkv_row_index(cfg: GPTConfig) -> torch.Tensor:
    """Rows of the fused QKV output that receive the LoRA delta."""
    kv_embd = cfg.n_embd // cfg.q_per_kv
    rows = []
    if cfg.lora_query:
        rows.extend(range(0, cfg.n_embd))
    if cfg.lora_key:
        rows.extend(range(cfg.n_embd, cfg.n_embd + kv_embd))
    if cfg.lora_value:
        rows.extend(range(cfg.n_embd + kv_embd, cfg.qkv_out_dim))
    return torch.tensor(rows, dtype=torch.long)


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _generator(seed, device):
    """The LoRA dropout's generator of one block pass, seeded with `seed`
    (None: no dropout), so a rematerialised pass draws the same masks."""
    if seed is None:
        return None
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return generator


def _dropout(x, rate: float, generator):
    """LoRA-input dropout (`_dropout` of the JAX package): each element kept
    with probability 1 - rate and scaled by 1 / (1 - rate)."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _fused_input(x, rate: float, generator):
    """The fused kernel's LoRA input: x after dropout, or None (the kernel
    then reads x once) when there is no dropout. The same generator draws as
    `_dropout`'s, so both LoRA paths drop the same elements."""
    if generator is None or rate <= 0.0:
        return None
    return _dropout(x, rate, generator)


class Norm(nn.Module):
    """A norm's fp32 leaves: `scale`, and `bias` for a LayerNorm
    (`_norm_leaves` of the JAX package)."""

    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        self.eps = cfg.norm_eps
        self.scale = _param((cfg.n_embd,), torch.float32, device)
        self.register_parameter(
            "bias", _param((cfg.n_embd,), torch.float32, device)
            if cfg.norm_class == "LayerNorm" else None)

    def forward(self, x):
        """RMSNorm (K2, `ops/rmsnorm.rms_norm`) or, with a bias, LayerNorm
        (plain PyTorch, as the JAX package leaves it to XLA)."""
        if self.bias is None:
            return norm_ops.rms_norm(x, self.scale, self.eps)
        return norm_ops.layer_norm(x, self.scale, self.bias, self.eps)


class Embedding(nn.Module):
    def __init__(self, n, d, dtype, device):
        super().__init__()
        self.weight = _param((n, d), dtype, device)


class _Frozen(nn.Module):
    """The frozen weight of a linear (`_base_linear` of the JAX package):
    `weight`, or after `set_quantized` the int8 leaves `weight_q8` and
    `weight_scale` or the int4 leaves `weight_q4` and `weight_scale4`; its
    optional `bias` in the compute dtype; and adapter v2's fp32
    `adapter_scale` and `adapter_bias`, which quantizing keeps too."""

    quant = None  # None, "int8" or "int4"
    fused = False  # the LoRA branch through kernel K5
    # tensor parallel (`GPT(mesh=)`): "col" holds rows [lo, lo + n) of the
    # out dim, "row" columns of the in dim; the group and this rank's index
    tp_kind = None
    tp_group = None
    tp_index = 0

    def _shard(self, t, dim: int):
        """A leaf the model keeps whole, as this rank uses it: its slice
        that meets the rank's piece of the weight (`_slice_dim`: the out
        dim of a column-parallel linear, the in dim of a row-parallel one),
        through `comm.copy_to`, so that its gradient sums over the tensor
        ranks. The leaf itself where there is no tensor parallelism."""
        if self.tp_group is None:
            return t
        n = self._local_extent()
        return comm.copy_to(t, self.tp_group).narrow(dim, self.tp_index * n, n)

    def _local_extent(self) -> int:
        """This rank's extent of the sharded dim of the weight."""
        w = next(getattr(self, k) for k in ("weight", "weight_q8", "weight_q4")
                 if getattr(self, k, None) is not None)
        if self.tp_kind == "col":
            return w.shape[0]
        # a row-parallel in dim: int4 packs two a byte
        return w.shape[1] * (2 if self.quant == "int4" else 1)

    def _col(self, t):
        """A per-output-row leaf (bias, adapter v2's vectors) as this rank
        uses it: its rows of a column-parallel linear."""
        return self._shard(t, 0) if self.tp_kind == "col" else t

    def _init_bias(self, out_f, cfg: GPTConfig, bias: bool, dtype, device) -> None:
        self.register_parameter("bias", _param((out_f,), dtype, device) if bias else None)
        for name in ("adapter_scale", "adapter_bias"):
            self.register_parameter(name, _param((out_f,), torch.float32, device)
                                    if cfg.use_adapter_v2 else None)

    def _add_bias(self, y):
        return y if self.bias is None else y + self._col(self.bias).to(y.dtype)

    def _adapt(self, y):
        """Adapter v2's (y + adapter_bias) * adapter_scale in y's dtype,
        after the bias and the LoRA delta (identity without v2)."""
        if self.adapter_scale is None:
            return y
        return ((y + self._col(self.adapter_bias).to(y.dtype))
                * self._col(self.adapter_scale).to(y.dtype))

    def set_quantized(self, leaves: dict) -> None:
        """Replace `weight` by quantized leaves ({name: tensor})."""
        del self.weight
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.quant = "int4" if quant_ops.Q4_KEY in leaves else "int8"

    def product(self, x):
        """The frozen product."""
        if self.quant == "int8" and self.tp_kind == "row":
            # x is this rank's columns of its rows: their absmax is the rows'
            absmax = x.to(torch.float32).abs().amax(dim=-1, keepdim=True)
            comm.all_reduce_(absmax, self.tp_group, torch.distributed.ReduceOp.MAX)
            return quant_ops.qmatmul(x, self.weight_q8, self.weight_scale, absmax)
        if self.quant == "int8":
            return quant_ops.qmatmul(x, self.weight_q8, self.weight_scale)
        if self.quant == "int4":
            return quant_ops.q4matmul(x, self.weight_q4, self.weight_scale4)
        return mlp_ops.linear(x, self.weight)

    def base(self, x):
        """The frozen product plus the bias."""
        return self._add_bias(self.product(x))

    def _row_finish(self, y):
        """A row-parallel linear's partial product summed over the tensor
        ranks, then the bias, once (`comm.reduce_from`)."""
        return self._add_bias(comm.reduce_from(y, self.tp_group))

    def use_fused(self) -> bool:
        """K5 runs a LoRA linear when asked for, never a quantized one
        (`_use_fused_lora` of the JAX package)."""
        return self.fused and self.with_lora and self.quant is None


class Linear(_Frozen):
    """torch-layout linear with an optional LoRA branch and adapter v2's wrap.

    As `_apply_linear` of the JAX package: the fp32 A and B are cast to x's
    dtype, the two products run in it on the dropped-out input, and then
    come the scaling and the layer gate (a gated-off layer skips the branch,
    whose leaves then get no gradient: zero, as the JAX gate's). With
    `fused`, kernel K5 computes the whole linear, the gate folded into its
    scale (a gated-off layer's LoRA gradients are then zero products). The
    v2 wrap comes last on both paths."""

    def __init__(self, in_f, out_f, cfg: GPTConfig, with_lora: bool, dtype, device,
                 fused: bool = False, bias: bool = False):
        super().__init__()
        self.scaling = cfg.lora_scaling
        self.dropout = cfg.lora_dropout
        self.weight = _param((out_f, in_f), dtype, device)
        self._init_bias(out_f, cfg, bias, dtype, device)
        self.with_lora = with_lora and cfg.lora_r > 0
        self.fused = fused
        if self.with_lora:
            self.lora_A = _param((cfg.lora_r, in_f), torch.float32, device)
            self.lora_B = _param((out_f, cfg.lora_r), torch.float32, device)

    def _lora_leaves(self):
        """(A, B) as this rank uses them: B's rows of a column-parallel
        linear, A's columns of a row-parallel one (`_shard`)."""
        a, b = self.lora_A, self.lora_B
        if self.tp_kind == "col":
            return comm.copy_to(a, self.tp_group), self._shard(b, 0)
        if self.tp_kind == "row":
            return self._shard(a, 1), comm.copy_to(b, self.tp_group)
        return a, b

    def forward(self, x, lora_on: bool = True, generator=None):
        row = self.tp_kind == "row"
        finish = self._row_finish if row else self._add_bias
        if self.use_fused():
            a, b = self._lora_leaves()
            return self._adapt(finish(lora_ops.lora_linear(
                x, self.weight, a, b, self.scaling * float(lora_on),
                xin=_fused_input(x, self.dropout, generator))))
        y = self.product(x) if row else self.base(x)
        if self.with_lora and lora_on:
            a, b = self._lora_leaves()
            xin = _dropout(x, self.dropout, generator)
            delta = (xin @ a.to(x.dtype).t()) @ b.to(x.dtype).t()
            y = y + delta * self.scaling
        return self._adapt(self._row_finish(y) if row else y)


class QKV(_Frozen):
    """Fused QKV projection with the reference's LoRA arithmetic
    (`_apply_qkv` of the JAX package). With `fused` and all of q, k and v
    enabled, kernel K5 computes it, B made block-diagonal (rank 3r). Adapter
    v2's vectors have `qkv_out_dim` rows in the interleaved order."""

    def __init__(self, cfg: GPTConfig, dtype, device, fused: bool = False):
        super().__init__()
        self.cfg = cfg
        self.fused = fused
        d = cfg.n_embd
        self.weight = _param((cfg.qkv_out_dim, d), dtype, device)
        self._init_bias(cfg.qkv_out_dim, cfg, cfg.bias, dtype, device)
        self.shapes = lora_qkv_shapes(cfg) if cfg.lora_r > 0 else ()
        self.with_lora = bool(self.shapes)
        if self.with_lora:
            self.lora_A = _param((cfg.lora_r * len(self.shapes), d), torch.float32, device)
            self.lora_B = _param((sum(self.shapes), cfg.lora_r), torch.float32, device)
            if len(self.shapes) < 3:
                self.register_buffer("rows", lora_qkv_row_index(cfg).to(device),
                                     persistent=False)

    def forward(self, x, lora_on: bool = True, generator=None):
        """Under tensor parallelism (column parallel by query group) the
        LoRA delta is formed over the whole output, its leaves through
        `comm.copy_to`, and this rank's rows of it are kept."""
        cfg = self.cfg
        lora_a, lora_b = (self.lora_A, self.lora_B) if self.with_lora else (None, None)
        if self.with_lora and self.tp_group is not None:
            lora_a = comm.copy_to(lora_a, self.tp_group)
            lora_b = comm.copy_to(lora_b, self.tp_group)
        if self.use_fused() and len(self.shapes) == 3:
            b_bd = lora_ops.lora_qkv_block_b(lora_b, self.shapes, cfg.lora_r)
            if self.tp_group is not None:
                n = self._local_extent()
                b_bd = b_bd.narrow(0, self.tp_index * n, n)
            return self._adapt(self._add_bias(lora_ops.lora_linear(
                x, self.weight, lora_a, b_bd, cfg.lora_scaling * float(lora_on),
                xin=_fused_input(x, cfg.lora_dropout, generator))))
        y = self.base(x)
        if not (self.with_lora and lora_on):
            return self._adapt(y)
        r = self.cfg.lora_r
        xin = _dropout(x, self.cfg.lora_dropout, generator)
        after_a = xin @ lora_a.to(x.dtype).t()
        lora_b = lora_b.to(x.dtype)
        outs = []
        row = 0
        for i, extent in enumerate(self.shapes):
            b_i = lora_b[row:row + extent]
            outs.append(after_a[..., i * r:(i + 1) * r] @ b_i.t())
            row += extent
        delta = torch.cat(outs, dim=-1) * self.cfg.lora_scaling
        if len(self.shapes) == 3:
            # all three enabled: the [q | k | v] delta lands on the
            # interleaved output as it is (the reference's layout quirk)
            padded = delta
        else:
            padded = y.new_zeros((*y.shape[:-1], cfg.qkv_out_dim))
            padded[..., self.rows] = delta.to(y.dtype)
        if self.tp_group is not None:
            n = self._local_extent()
            padded = padded.narrow(-1, self.tp_index * n, n)
        return self._adapt(y + padded.to(y.dtype))


def _cache_entries(k, v, n: int):
    """What a layer's cache of n tensors stores of k and v (.., T or no
    token axis, D): (k, v) for a float cache; the int8 values and scales
    (k_q, v_q, k_scale, v_scale) for an int8 one."""
    if n == 2:
        return k, v
    (k_q, k_sc), (v_q, v_sc) = quant_ops.q8_rows(k), quant_ops.q8_rows(v)
    return k_q, v_q, k_sc, v_sc


def split_heads(cfg: GPTConfig, qkv):
    """(B, T, QKV) -> q (B, G, q_per_kv, T, D), k, v (B, G, T, D), all views.

    The fused layout interleaves per query group: [q * q_per_kv, k, v]."""
    b, t, width = qkv.shape
    qpk, hs = cfg.q_per_kv, cfg.head_size
    # the groups this rank holds (all of them but under tensor parallelism)
    g = width // ((qpk + 2) * hs)
    qkv = qkv.view(b, t, g, qpk + 2, hs)
    q = qkv[:, :, :, :qpk].permute(0, 2, 3, 1, 4)
    k = qkv[:, :, :, qpk].transpose(1, 2)
    v = qkv[:, :, :, qpk + 1].transpose(1, 2)
    return q, k, v


class Attention(nn.Module):
    """The attention's linears, and adapter v1's leaves: `adapter_wte`
    (adapter_prompt_length, d) and `gating_factor` (n_head,), fp32."""

    def __init__(self, cfg: GPTConfig, dtype, device, fused: bool = False):
        super().__init__()
        self.cfg = cfg
        self.qkv = QKV(cfg, dtype, device, fused)
        self.proj = Linear(cfg.n_embd, cfg.n_embd, cfg, cfg.lora_projection,
                           dtype, device, fused, cfg.bias)
        if cfg.use_adapter:
            self.adapter_wte = _param((cfg.adapter_prompt_length, cfg.n_embd),
                                      torch.float32, device)
            self.gating_factor = _param((cfg.n_head,), torch.float32, device)

    def prefix(self, q):
        """Adapter v1's prefix attention (`_adapter_attention` and
        `_full_prefix_attention` of the JAX package) for the post-RoPE
        queries q (B, Hq, T, D): the prefix rows, in q's dtype, through this
        block's QKV (LoRA ungated, no dropout, adapter v2's wrap), their K
        and V unrotated; logits in fp32 over every prefix row, softmax,
        probabilities rounded to q's dtype, then P V in q's dtype; gated per
        head by `gating_factor`. Plain PyTorch, as XLA runs it there."""
        cfg = self.cfg
        b, hq, t, d = q.shape
        wte = comm.copy_to(self.adapter_wte, self.qkv.tp_group)
        _, ak, av = split_heads(cfg, self.qkv(wte.to(q.dtype)[None]))
        groups = ak.shape[1]
        qg = q.reshape(b, groups, hq // groups, t, d)
        logits = (qg.float() @ ak.float()[:, :, None].transpose(-1, -2)) * (
            1.0 / math.sqrt(cfg.head_size))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = (probs @ av[:, :, None]).reshape(b, hq, t, d)
        gate = self.gating_factor
        if self.qkv.tp_group is not None:
            # this rank's heads of the gate
            gate = comm.copy_to(gate, self.qkv.tp_group).narrow(0, self.qkv.tp_index * hq, hq)
        return out * gate.to(q.dtype)[None, :, None, None]


class MLP(nn.Module):
    """The gated MLP (LLaMA silu, Gemma tanh-gelu): fc_1, fc_2, proj, with
    LoRA on each under `lora_mlp` (K5 when `fused`)."""

    def __init__(self, cfg: GPTConfig, dtype, device, fused: bool = False):
        super().__init__()
        d, inter = cfg.n_embd, cfg.intermediate_size
        self.gate = "silu" if cfg.mlp_class == "LLaMAMLP" else "gelu"
        self.fc_1 = Linear(d, inter, cfg, cfg.lora_mlp, dtype, device, fused, cfg.bias)
        self.fc_2 = Linear(d, inter, cfg, cfg.lora_mlp, dtype, device, fused, cfg.bias)
        self.proj = Linear(inter, d, cfg, cfg.lora_mlp, dtype, device, fused, cfg.bias)

    tp_group = None  # tensor parallel: fc_1 / fc_2 column, proj row parallel

    def forward(self, x, lora_on: bool = True, seed=None):
        """seed: the LoRA dropout's generator seed of this MLP pass (None:
        no dropout), so a rematerialised MLP draws the same masks."""
        x = comm.copy_to(x, self.tp_group)
        fc_1 = self.fc_1
        if (fc_1.quant is not None or fc_1.bias is not None or fc_1.with_lora
                or fc_1.adapter_scale is not None):
            # `_mlp`'s unfused branch, as the JAX package takes it for LoRA,
            # adapter v2, quantized leaves and biases: K4 does not run
            generator = _generator(seed, x.device)
            h1 = fc_1(x, lora_on, generator)
            act = F.silu(h1) if self.gate == "silu" else F.gelu(h1, approximate="tanh")
            return self.proj(act * self.fc_2(x, lora_on, generator), lora_on, generator)
        return comm.reduce_from(mlp_ops.swiglu_mlp(
            x, fc_1.weight, self.fc_2.weight, self.proj.weight, gate=self.gate), self.tp_group)


class GptNeoxMLP(nn.Module):
    """The GPT-NeoX MLP (`_mlp`'s last branch of the JAX package): proj(gelu(
    fc(x))), gelu exact or, with `gelu_approximate="tanh"`, its tanh form
    (plain products: the JAX package runs no kernel here), LoRA on both
    under `lora_mlp`."""

    def __init__(self, cfg: GPTConfig, dtype, device, fused: bool = False):
        super().__init__()
        d, inter = cfg.n_embd, cfg.intermediate_size
        self.approximate = "tanh" if cfg.gelu_approximate == "tanh" else "none"
        self.fc = Linear(d, inter, cfg, cfg.lora_mlp, dtype, device, fused, cfg.bias)
        self.proj = Linear(inter, d, cfg, cfg.lora_mlp, dtype, device, fused, cfg.bias)

    tp_group = None  # tensor parallel: fc column, proj row parallel

    def forward(self, x, lora_on: bool = True, seed=None):
        generator = _generator(seed, x.device)
        x = comm.copy_to(x, self.tp_group)
        h = F.gelu(self.fc(x, lora_on, generator), approximate=self.approximate)
        return self.proj(h, lora_on, generator)


class Stack(nn.Module):
    """A stack of expert matrices, `weight` (E, out, in) in the compute
    dtype (an fp32 master in mode "full"), or the router's (E, d)."""

    def __init__(self, shape, dtype, device):
        super().__init__()
        self.weight = _param(shape, dtype, device)


class PermuteRows(torch.autograd.Function):
    """`x.index_select(0, perm)` whose backward is the inverse gather
    `grad.index_select(0, inv)` (`_permute_rows` of the JAX package): for a
    permutation that is the whole gradient, where index_select's own
    backward would scatter-add it with atomics."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        return grad.index_select(0, inv), None, None


def permute_rows(x, perm, inv):
    """Rows of x in the order `perm`, whose inverse permutation is `inv`."""
    return PermuteRows.apply(x, perm, inv)


def moe_top_k(router, k: int):
    """The k largest of each row of fp32 router logits (..., E) and their
    expert ids, ties toward the lower id as `jax.lax.top_k` breaks them: a
    stable descending sort (torch.topk promises no order among equal values
    on the card, and bf16 router logits tie often)."""
    values, ids = torch.sort(router, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


class MoE(nn.Module):
    """Mixtral-style sparse MoE (`_moe_mlp` and `_moe_mlp_sparse` of the JAX
    package): the router `gate` (E, d), the expert stacks `fc_1`, `fc_2` (E,
    inter, d) and `proj` (E, d, inter), silu gate; each token mixes its top
    k experts with softmax weights over their logits.

    Under a mesh (`GPT(mesh=)`) a rank holds experts [e0, e0 + E_local) of
    the stacks (expert parallel) and its columns of the intermediate dim
    (tensor parallel). Every rank routes all rows from the replicated x;
    the products see x and the mixing weights through `comm.copy_to`, so
    their gradients sum over the ranks; the weighted partial sums are
    all-reduced over `tp_group` (the psum of the JAX package's combine; no
    all-to-all). The sparse path sorts the slots with the local experts
    first ((expert - e0) mod E), so L2 runs on the local group sizes and the
    rows past them come out zero.

    impl "dense" runs every expert on every token and mixes with zero
    weights elsewhere (the JAX default; plain einsums, as XLA runs them
    there). "sparse" and "megablox" sort the token slots by expert and run
    the three grouped products through L2 (`ops/gmm.grouped_matmul`), in
    three steps that remat="moe" checkpoints apart: `route` (the router,
    the sort, the sorted rows xr), `up` (g1, g2) and `down` (the proj
    product, the unsort, the mix). No host sync, forward or backward, so a
    decode step keeps its one."""

    tp_group = None  # the group over which the products are split
    e0 = 0  # the first local expert

    def __init__(self, cfg: GPTConfig, dtype, device, impl: str):
        super().__init__()
        e, d, inter = cfg.n_expert, cfg.n_embd, cfg.intermediate_size
        self.top_k = cfg.n_expert_per_token
        self.impl = impl
        self.gate = Stack((e, d), dtype, device)
        self.fc_1 = Stack((e, inter, d), dtype, device)
        self.fc_2 = Stack((e, inter, d), dtype, device)
        self.proj = Stack((e, d, inter), dtype, device)

    def forward(self, x, lora_on: bool = True, seed=None):
        """lora_on, seed: unused (the expert stacks carry no LoRA)."""
        if self.impl == "dense":
            return self._dense(x)
        return self._sparse(x)

    def _dense(self, x):
        router = (x @ self.gate.weight.to(x.dtype).t()).float()
        top_vals, top_ids = moe_top_k(router, self.top_k)
        top_w = torch.softmax(top_vals, dim=-1)
        # one weight an expert: the top-k softmax at its ids, zero elsewhere
        weights = torch.zeros(router.shape, dtype=router.dtype, device=x.device)
        weights = weights.scatter(-1, top_ids, top_w).to(x.dtype)
        if self.tp_group is not None:
            x = comm.copy_to(x, self.tp_group)
            weights = comm.copy_to(weights, self.tp_group).narrow(
                -1, self.e0, self.fc_1.weight.shape[0])
        h1 = torch.einsum("...d,eod->...eo", x, self.fc_1.weight.to(x.dtype))
        h2 = torch.einsum("...d,eod->...eo", x, self.fc_2.weight.to(x.dtype))
        h = F.silu(h1) * h2
        out = torch.einsum("...eo,edo->...ed", h, self.proj.weight.to(x.dtype))
        return comm.reduce_from(torch.einsum("...ed,...e->...d", out, weights),
                                self.tp_group)

    def route(self, x):
        """The sparse path's routing of x (.., d): (xr (N*K, d), the token
        slots' rows sorted by expert; the top-k softmax weights (N, K); the
        sort order and its inverse; the group sizes (E,) int32). Each row is
        replicated k times by an explicit broadcast (its backward a sum over
        k) and sorted by `permute_rows` (its backward the inverse gather),
        as `_moe_mlp_sparse` does."""
        e, k = self.gate.weight.shape[0], self.top_k
        xf = x.reshape(-1, x.shape[-1])
        n, d = xf.shape
        router = (xf @ self.gate.weight.to(x.dtype).t()).float()
        top_vals, top_ids = moe_top_k(router, k)
        weights = torch.softmax(top_vals, dim=-1).to(x.dtype)
        ef = top_ids.reshape(-1)  # (N*K,) the expert of each flat slot
        if self.e0:
            ef = (ef - self.e0) % e  # the local experts first
        order = torch.sort(ef, stable=True).indices  # ties keep token order
        iota = torch.arange(n * k, device=x.device)
        inv = torch.empty_like(order).scatter_(0, order, iota)
        if self.tp_group is not None:
            xf = comm.copy_to(xf, self.tp_group)
            weights = comm.copy_to(weights, self.tp_group)
        xr = permute_rows(xf[:, None].expand(n, k, d).reshape(n * k, d), order, inv)
        group_sizes = torch.zeros(e, dtype=torch.int64, device=x.device)
        group_sizes = group_sizes.scatter_add_(0, ef, torch.ones_like(ef)).to(torch.int32)
        # the local experts' groups (all of them but under expert parallelism)
        group_sizes = group_sizes[:self.fc_1.weight.shape[0]]
        return xr, weights, order, inv, group_sizes

    def up(self, xr, group_sizes):
        """g1, g2: the two up products of the sorted rows."""
        return (gmm_ops.grouped_matmul(xr, self.fc_1.weight.to(xr.dtype), group_sizes),
                gmm_ops.grouped_matmul(xr, self.fc_2.weight.to(xr.dtype), group_sizes))

    def down(self, g1, g2, weights, order, inv, group_sizes):
        """The proj product of silu(g1) * g2, unsorted and mixed by each
        token's weights: (N, d)."""
        h = F.silu(g1) * g2
        out = gmm_ops.grouped_matmul(h, self.proj.weight.to(h.dtype), group_sizes)
        out = permute_rows(out, inv, order).reshape(*weights.shape, -1)
        return comm.reduce_from((out * weights[..., None]).sum(dim=1), self.tp_group)

    def _sparse(self, x):
        xr, weights, order, inv, group_sizes = self.route(x)
        g1, g2 = self.up(xr, group_sizes)
        return self.down(g1, g2, weights, order, inv, group_sizes).reshape(x.shape)


class Block(nn.Module):
    # sequence parallel: this rank's tokens are shard `seq_index` of the
    # sequence; q, k and v are all-gathered over `seq_group` for attention
    seq_group = None
    seq_index = 0

    def __init__(self, cfg: GPTConfig, layer_idx: int, dtype, device, fused: bool = False,
                 moe_impl: str = "dense"):
        super().__init__()
        self.cfg = cfg
        self.lora_on = layer_idx >= cfg.lora_start_layer
        # adapter v1's prefix attention is off below adapter_start_layer (the
        # JAX package multiplies it by a 0/1 gate there)
        self.adapter_on = cfg.use_adapter and layer_idx >= cfg.adapter_start_layer
        self.norm_1 = Norm(cfg, device)
        self.attn = Attention(cfg, dtype, device, fused)
        if not cfg.shared_attention_norm:
            self.norm_2 = Norm(cfg, device)
        if cfg.mlp_class == "LLaMAMoE":
            self.mlp = MoE(cfg, dtype, device, moe_impl)
        elif cfg.mlp_class == "GptNeoxMLP":
            self.mlp = GptNeoxMLP(cfg, dtype, device, fused)
        else:
            self.mlp = MLP(cfg, dtype, device, fused)

    def forward(self, x, cos, sin, cache_kv=None, positions=None,
                kv_length=None, active=None, seed=None, mlp_remat=False):
        """x: (B, T, d). cache_kv: this layer's (k, v) cache, or (k, v,
        k_scale, v_scale) for an int8 cache, written in place: at slot 0 in
        prefill (positions None), at `positions` in a decode step (T == 1),
        for the rows where `active` holds, and at positions..positions+T-1 of
        every row in a verify step (T > 1, cos and sin then the rows of
        `rope.gather_rope_rows`). An int8 cache takes K/V rounded
        by `q8_rows` over D; prefill attends the exact K/V. seed: the
        LoRA dropout masks of this block come from a generator seeded with
        it, so a rematerialised pass draws the same masks (None: no
        dropout). mlp_remat: the MLP is rematerialised in the backward
        (remat="mlp")."""
        res, n2 = self._attend(x, cos, sin, _generator(seed, x.device), cache_kv,
                               positions, kv_length, active)
        # the MLP's LoRA dropout draws from a generator of its own
        mlp_seed = None if seed is None else seed + 1
        if mlp_remat:
            return res + checkpoint(self.mlp, n2, self.lora_on, mlp_seed,
                                    use_reentrant=False, preserve_rng_state=False)
        return res + self.mlp(n2, self.lora_on, mlp_seed)

    def forward_moe_remat(self, x, cos, sin, seed=None):
        """The training pass under remat="moe" for a sparse MoE block (the
        JAX package's policy that saves only `moe_xr`, `moe_g1`, `moe_g2`
        across the block's remat boundary). Three pieces: the attention half
        and the routing, rematerialised from x; the up products g1, g2, kept;
        the down product and the mix, rematerialised from g1 and g2. So the
        backward re-runs one forward grouped product (proj, whose output the
        mix's gradient reads) of three. xr is kept only where a product's
        backward reads it, which is when the expert stacks take gradients:
        under LoRA they do not, and the backward re-gathers it."""

        def attend_and_route(x):
            res, n2 = self._attend(x, cos, sin, _generator(seed, x.device))
            return (res, *self.mlp.route(n2))

        res, xr, weights, order, inv, group_sizes = checkpoint(
            attend_and_route, x, use_reentrant=False, preserve_rng_state=False)
        g1, g2 = self.mlp.up(xr, group_sizes)
        y = checkpoint(self.mlp.down, g1, g2, weights, order, inv, group_sizes,
                       use_reentrant=False, preserve_rng_state=False)
        return res + y.reshape(res.shape)

    def _attend(self, x, cos, sin, generator, cache_kv=None, positions=None,
                kv_length=None, active=None):
        """The attention half of the block: (x + the attention output, the
        MLP's normed input)."""
        cfg = self.cfg
        b, t, _ = x.shape
        n1 = self.norm_1(x)
        qkv = self.attn.qkv(comm.copy_to(n1, self.attn.qkv.tp_group), self.lora_on, generator)
        q, k, v = split_heads(cfg, qkv)
        # this rank's heads (all of them but under tensor parallelism)
        nh, hs = q.shape[1] * q.shape[2], cfg.head_size
        if positions is None:
            q = rope_ops.apply_rope(q, cos[:t], sin[:t]).reshape(b, nh, t, hs)
            k = rope_ops.apply_rope(k, cos[:t], sin[:t])
        elif t == 1:
            q = rope_ops.apply_rope_gathered(q.reshape(b, nh, t, hs), cos, sin, positions)
            k = rope_ops.apply_rope_gathered(k, cos, sin, positions)
        else:
            # a verify chunk: cos, sin are the rows at positions + i, gathered
            # once a step (`GPT.verify_step`)
            q = rope_ops.apply_rope_rows(q.reshape(b, nh, t, hs), cos, sin)
            k = rope_ops.apply_rope_rows(k, cos, sin)

        if cache_kv is None and self.seq_group is not None:
            # the whole sequence's q, k, v; attention on it; this shard's rows
            whole = [comm.all_gather(z, 2, self.seq_group) for z in (q, k, v)]
            y = attn_ops.causal_attention(*whole).narrow(2, self.seq_index * t, t)
        elif cache_kv is None:
            y = attn_ops.causal_attention(q, k, v)
        elif positions is None:
            # prefill: the whole prompt goes to slot 0; attention reads the
            # exact k, v
            for c, new in zip(cache_kv, _cache_entries(k, v, len(cache_kv))):
                c[:, :, :t] = new.to(c.dtype)
            y = attn_ops.causal_attention(q, k, v)
        elif t > 1:
            # a verify chunk: every row's T slots from positions on (clamped
            # to fit, as `dynamic_update_slice` clamps a start), inactive
            # rows too, as in the JAX package
            start = positions.clamp(min=0, max=cache_kv[0].shape[2] - t)
            rows = torch.arange(b, device=x.device)[:, None]
            slots = start[:, None] + torch.arange(t, device=x.device)[None, :]
            for c, new in zip(cache_kv, _cache_entries(k, v, len(cache_kv))):
                c[rows, :, slots] = new.transpose(1, 2).to(c.dtype)
            scales = cache_kv[2:] if len(cache_kv) == 4 else (None, None)
            y = attn_ops.chunk_decode_attention(q, cache_kv[0], cache_kv[1], positions,
                                                k_scale=scales[0], v_scale=scales[1])
        else:
            rows = torch.arange(b, device=x.device)
            for c, new in zip(cache_kv, _cache_entries(k[:, :, 0], v[:, :, 0], len(cache_kv))):
                new = new.to(c.dtype)
                if active is not None:
                    # an inactive row writes back what its slot holds (a
                    # blend, not a boolean index: no wait on the device)
                    keep = ~active.view(-1, *([1] * (new.dim() - 1)))
                    new = torch.where(keep, c[rows, :, positions], new)
                c[rows, :, positions] = new
            scales = cache_kv[2:] if len(cache_kv) == 4 else (None, None)
            y = attn_ops.decode_attention(q, cache_kv[0], cache_kv[1], kv_length,
                                          k_scale=scales[0], v_scale=scales[1])

        if self.adapter_on:
            y = y + self.attn.prefix(q)
        y = y.transpose(1, 2).reshape(b, t, nh * hs)
        h = self.attn.proj(y, self.lora_on, generator)
        if cfg.parallel_residual:
            n2 = n1 if cfg.shared_attention_norm else self.norm_2(x)
            return x + h, n2
        x = x + h
        return x, self.norm_2(x)


# the LoRA linears' two implementations: "xla" the composition (the JAX
# package's default name for it), "fused" kernel K5
LORA_IMPLS = ("xla", "fused")
# the MoE's: "dense" the einsums over every expert (the JAX default);
# "sparse" and "megablox" the grouped matmul L2 over sorted rows
MOE_IMPLS = ("dense", "sparse", "megablox")
# `GPT.forward`'s rematerialisation: none, whole blocks, the MLP alone, or a
# block but its MoE up products (the JAX package's `remat` values)
REMAT_MODES = (False, True, "mlp", "moe")


class GPT(nn.Module):
    """The model. `device=None` means the card, and raises without one.
    `lora_impl`: "xla" (the composition) or "fused" (kernel K5); None reads
    `DUALHYP_LORA_IMPL`, "xla" when unset. `moe_impl` (an MoE config):
    "dense", "sparse" or "megablox" (the grouped matmul L2); None reads
    `DUALHYP_MOE_IMPL`, "dense" when unset.

    mesh (`parallel.make_mesh`): the model is this rank's local piece of the
    sharded model. Its parameters are made on the meta device and then only
    the rank's pieces (`sharding.model_spec`) on `device`; `load_tree` takes
    the rank's pieces of a whole tree. On the mesh's axes:
      * tensor: QKV column parallel by query group (n_query_groups %
        tensor == 0), fc_1 / fc_2 / fc by intermediate, attn.proj and
        mlp.proj row parallel with an all-reduce (a bias added once, after
        it), the head column parallel over the vocab with its logits
        gathered; Megatron's f and g (`comm.copy_to`, `comm.reduce_from`)
        on each region's input and output;
      * expert: an MoE's local experts (`MoE`);
      * seq: the rows of `forward`'s idx are shard `seq` of the sequence;
        RoPE rows start at the shard's offset, attention runs on the
        all-gathered q, k, v and keeps the shard's rows (`Block`); the
        norms and the MLP stay local;
      * fsdp: a leaf the rule shards over fsdp is stored as its shard and
        all-gathered (`gathered`) before the module that uses it runs: a
        block at a time, the embedding, the head. The gather's backward
        reduce-scatters the gradient. Its gathered weights are freed after
        the block where the block is rematerialised (remat "mlp" and "moe"
        take whole blocks under fsdp); else autograd keeps them for the
        backward;
      * pipe (`parallel.make_pipe_mesh`): the rank holds the blocks of its
        stage alone (the others are empty modules) and runs them through
        `parallel.pipeline`.
    The data axis needs nothing of the model: the batch is split by the
    caller (the trainer, the decoders) and the gradients summed by it."""

    mesh = None
    _tp_group = None  # the head's tensor group (column parallel over the vocab)

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=torch.bfloat16,
                 lora_impl=None, moe_impl=None, mesh=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        if mesh is not None:
            tensor = mesh.shape.get("tensor", 1)
            if cfg.n_query_groups % tensor:
                raise ValueError(f"n_query_groups {cfg.n_query_groups} does not split "
                                 f"over tensor {tensor}")
        final_device, device = device, torch.device("meta") if mesh is not None else device
        if lora_impl is None:
            lora_impl = os.environ.get("DUALHYP_LORA_IMPL", "xla")
        if lora_impl not in LORA_IMPLS:
            raise ValueError(f"lora_impl {lora_impl!r} not in {LORA_IMPLS}")
        if moe_impl is None:
            moe_impl = os.environ.get("DUALHYP_MOE_IMPL") or "dense"
        if moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {moe_impl!r} not in {MOE_IMPLS}")
        fused = lora_impl == "fused"
        self.cfg = cfg
        self.dtype = dtype
        self.lora_impl = lora_impl
        self.moe_impl = moe_impl
        self.wte = Embedding(cfg.effective_padded_vocab_size, cfg.n_embd, dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, i, dtype, device, fused, moe_impl) for i in range(cfg.n_layer))
        self.ln_f = Norm(cfg, device)
        self.lm_head = Linear(cfg.n_embd, cfg.padded_vocab_size, cfg,
                              cfg.lora_head, dtype, device, fused, cfg.lm_head_bias)
        if cfg.use_relprompt:
            # the reliability classifiers over the audio and visual features
            self.audio_noise_classifier = NoiseClassifier(
                cfg.whisper_dim, cfg.classifier_hidden_dim, device)
            self.visual_noise_classifier = NoiseClassifier(
                cfg.raven_dim, cfg.classifier_hidden_dim, device)
        cos, sin = rope_ops.build_rope_cache(
            cfg.block_size, cfg.rope_n_elem, base=cfg.rope_base,
            condense_ratio=cfg.rope_condense_ratio, dtype=dtype, device=final_device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)
        self.layer_range = range(cfg.n_layer)
        self._fsdp_group = None
        if mesh is not None:
            self._localize(mesh, final_device)

    # ---- the local model of a mesh ----
    @staticmethod
    def leaf_path(name: str):
        """(tree path, stacked) of parameter `name`: `blocks.3.attn.qkv.
        weight` is leaf `blocks/attn/qkv/weight` of the stacked tree."""
        parts = name.split(".")
        if parts[0] == "blocks":
            return "/".join(["blocks", *parts[2:]]), True
        return "/".join(parts), False

    def _localize(self, mesh, device) -> None:
        """Replace the meta parameters by this rank's pieces on `device`
        (empty, to be loaded) and set the modules' collectives."""
        cfg = self.cfg
        self.mesh = mesh
        pipe = "pipe" in mesh.shape
        if pipe:
            stages = mesh.shape["pipe"]
            if cfg.n_layer % stages:
                raise ValueError(f"n_layer {cfg.n_layer} does not split over {stages} stages")
            per = cfg.n_layer // stages
            self.layer_range = range(mesh.coords["pipe"] * per, (mesh.coords["pipe"] + 1) * per)
            for i in range(cfg.n_layer):
                if i not in self.layer_range:
                    self.blocks[i] = nn.Module()  # another stage's block
        self.specs = {}
        for name, p in list(self.named_parameters()):
            path, stacked = self.leaf_path(name)
            full = (cfg.n_layer, *p.shape) if stacked else tuple(p.shape)
            spec = (None,) * len(full) if pipe else sharding.model_spec(path, full, mesh)
            bounds = sharding.piece_bounds(full, spec, mesh)
            shape = [b - a for a, b in bounds][int(stacked):]
            spec = spec[int(stacked):]
            mod_name, leaf = name.rsplit(".", 1)
            mod = self.get_submodule(mod_name)
            mod._parameters[leaf] = nn.Parameter(
                torch.empty(shape, dtype=p.dtype, device=device), requires_grad=False)
            self.specs[name] = spec
            if "fsdp" in spec:
                if "_fsdp_dims" not in mod.__dict__:
                    mod._fsdp_dims = {}
                mod._fsdp_dims[leaf] = spec.index("fsdp")
        if mesh.shape.get("fsdp", 1) > 1:
            self._fsdp_group = mesh.group("fsdp")
        for mod in self.modules():
            if isinstance(mod, QKV) and hasattr(mod, "rows"):
                mod.rows = lora_qkv_row_index(cfg).to(device)
        if pipe:
            return
        tensor = mesh.shape.get("tensor", 1) > 1
        tp_group, tp_index = (mesh.group("tensor"), mesh.index("tensor")) if tensor else (None, 0)
        for name, mod in self.named_modules():
            path, _ = self.leaf_path(name + ".weight")
            if isinstance(mod, _Frozen) and tensor:
                mod.tp_kind = ("col" if any(k in path for k in sharding.TENSOR_COLUMN)
                               else "row" if "proj/weight" in path else None)
                if mod.tp_kind is not None:
                    mod.tp_group, mod.tp_index = tp_group, tp_index
            elif isinstance(mod, (MLP, GptNeoxMLP)):
                mod.tp_group = tp_group
            elif isinstance(mod, MoE):
                axes = ["tensor"] if tensor else []
                local = mod.fc_1.weight.shape[0]
                if local < cfg.n_expert:
                    axes.append("expert")
                    mod.e0 = mesh.index("expert") * local
                mod.tp_group = mesh.group(*axes) if axes else None
            elif isinstance(mod, Block):
                if mesh.shape.get("seq", 1) > 1:
                    mod.seq_group, mod.seq_index = mesh.group("seq"), mesh.index("seq")
        self._tp_group = tp_group

    @contextlib.contextmanager
    def gathered(self, *modules):
        """The fsdp-sharded leaves of `modules` all-gathered for the
        duration (`comm.all_gather`: the gradient reduce-scatters back to
        the shards); nothing without fsdp."""
        saved = []
        if self._fsdp_group is not None:
            for module in modules:
                for m in module.modules():
                    for leaf, dim in m.__dict__.get("_fsdp_dims", {}).items():
                        p = m._parameters[leaf]
                        saved.append((m, leaf, p))
                        m._parameters[leaf] = comm.all_gather(p, dim, self._fsdp_group)
        try:
            yield
        finally:
            for m, leaf, p in saved:
                m._parameters[leaf] = p

    def _call(self, module, fn, *args, **kwargs):
        """fn(*args, **kwargs) with `module`'s fsdp leaves gathered."""
        if self._fsdp_group is None:
            return fn(*args, **kwargs)
        with self.gathered(module):
            return fn(*args, **kwargs)

    @property
    def local_blocks(self) -> list:
        """(layer index, block) of the blocks this rank holds."""
        return [(i, self.blocks[i]) for i in self.layer_range]

    @property
    def seq_offset(self) -> int:
        """Tokens before this rank's shard, in units of the shard's length."""
        return self.mesh.index("seq") if self.mesh is not None else 0

    def head_logits(self, hidden):
        """fp32 logits (.., padded_vocab) of final normed hidden states:
        the head (with its LoRA and adapter v2's wrap), gathered over the
        vocab under tensor parallelism."""
        with self.gathered(self.lm_head):
            logits = self.lm_head(comm.copy_to(hidden, self._tp_group)).float()
        return comm.gather_from(logits, -1, self._tp_group)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX package's distributions (`gpt.init`):
        normal weights (GPT-NeoX std; an MoE's router and fc stacks too, its
        proj stack at the projection std), uniform lora_A, zero lora_B, unit
        norm scales, zero biases (linears' and LayerNorms'); adapter v1's
        prefix normal at the GPT-NeoX std and zero gates, adapter v2's unit
        scales and zero biases. Draws in fp32 from `generator`, then
        casts. On a mesh every leaf is drawn whole, one at a time, and the
        rank keeps its piece: the values of a one-rank init."""
        cfg = self.cfg
        d = cfg.n_embd
        std = math.sqrt(2.0 / 5 / d)
        proj_std = 1.0 / math.sqrt(d) / cfg.n_layer
        if self.mesh is not None and "pipe" in self.mesh.shape:
            raise NotImplementedError("a pipeline stage loads its weights from a tree")
        whole = {} if self.mesh is None else {
            id(p): name for name, p in self.named_parameters()}

        def full_shape(p):
            if id(p) not in whole:
                return p.shape
            spec, shape = self.specs[whole[id(p)]], list(p.shape)
            for dim, entry in enumerate(spec):
                if entry is not None:
                    shape[dim] *= self.mesh.extent(entry)
            return shape

        def put(p, value):
            if id(p) in whole:
                value = sharding.local_piece(value, self.specs[whole[id(p)]], self.mesh)
            p.copy_(value)

        def normal(p, s):
            put(p, torch.randn(full_shape(p), generator=generator, device=p.device) * s)

        def lora(mod):
            if mod.with_lora:
                shape = full_shape(mod.lora_A)
                bound = 1.0 / math.sqrt(shape[1])
                a = torch.rand(shape, generator=generator, device=mod.lora_A.device)
                put(mod.lora_A, a * (2 * bound) - bound)
                mod.lora_B.zero_()

        normal(self.wte.weight, std)
        normal(self.lm_head.weight, std)
        lora(self.lm_head)
        for name, p in self.named_parameters():
            if name.endswith((".scale", ".adapter_scale")):
                p.fill_(1.0)
            elif name.endswith((".bias", ".adapter_bias", ".gating_factor")):
                p.zero_()
        for block in self.blocks:
            normal(block.attn.qkv.weight, std)
            lora(block.attn.qkv)
            normal(block.attn.proj.weight, proj_std)
            lora(block.attn.proj)
            if cfg.use_adapter:
                normal(block.attn.adapter_wte, std)
            if isinstance(block.mlp, MoE):
                normal(block.mlp.gate.weight, std)
            if isinstance(block.mlp, GptNeoxMLP):
                normal(block.mlp.fc.weight, std)
                lora(block.mlp.fc)
            else:
                normal(block.mlp.fc_1.weight, std)
                normal(block.mlp.fc_2.weight, std)
                if not isinstance(block.mlp, MoE):
                    lora(block.mlp.fc_1)
                    lora(block.mlp.fc_2)
            normal(block.mlp.proj.weight, proj_std)
            if not isinstance(block.mlp, MoE):
                lora(block.mlp.proj)
        if cfg.use_relprompt:
            self.audio_noise_classifier.init_weights(generator)
            self.visual_noise_classifier.init_weights(generator)

    def _embed(self, idx):
        with self.gathered(self.wte):
            x = self.wte.weight[idx].to(self.dtype)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(self.cfg.n_embd), dtype=x.dtype)
        return x

    def _head(self, x):
        if self.mesh is not None:
            return self.head_logits(self._norm_f(x))
        return self.lm_head(self.ln_f(x)).float()

    def _norm_f(self, x):
        with self.gathered(self.ln_f):
            return self.ln_f(x)

    def init_cache(self, batch_size: int, max_seq: int, quantize=None) -> list:
        """Per-layer [k, v] caches, each (B, G, S, D) zeros in the compute
        dtype. Only the n_query_groups KV heads are stored. quantize="int8":
        per-layer [k, v, k_scale, v_scale], int8 K/V and fp32 (B, G, S)
        per-slot scales."""
        cfg = self.cfg
        groups = cfg.n_query_groups // (self.mesh.shape.get("tensor", 1) if self.mesh else 1)
        shape = (batch_size, groups, max_seq, cfg.head_size)
        if quantize is None:
            dtypes = [(shape, self.dtype)] * 2
        elif quantize == "int8":
            dtypes = [(shape, torch.int8)] * 2 + [(shape[:-1], torch.float32)] * 2
        else:
            raise ValueError(f"unsupported KV-cache quantization: {quantize}")
        return [[torch.zeros(s, dtype=dt, device=self.device) for s, dt in dtypes]
                for _ in range(cfg.n_layer)]

    def trainable_parameters(self, mode: str = "lora") -> dict:
        """The leaves that train in `mode`, by parameter name: every
        floating leaf in "full" (`full_finetune_mask` of the JAX package),
        else the config's PEFT leaves (`trainable_mask`, `is_peft_leaf`)
        whatever the mode's name, as the JAX package's `select_mask`."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "full":
            return {name: p for name, p in self.named_parameters() if p.is_floating_point()}
        return {name: p for name, p in self.named_parameters() if is_peft_leaf(name, self.cfg)}

    def count_params(self, trainable_only: bool = False, mode: str = "lora") -> int:
        params = (self.trainable_parameters(mode).values() if trainable_only
                  else self.parameters())
        return sum(p.numel() for p in params)

    def forward(self, idx, *, generator=None, remat=False, return_hidden=False):
        """Training and evaluation pass, grad enabled. idx: (B, T) token ids.

        generator: draws one seed per block for the LoRA-input dropout (a
        CPU generator keeps the draw off the card's queue); None means no
        dropout. remat (`torch.utils.checkpoint` in the backward): True
        rematerialises each block, "mlp" each block's MLP alone, "moe" each
        block but the up products of a sparse MoE (`Block.forward_moe_remat`;
        whole blocks where no MoE runs L2, as the JAX policy degrades).
        Returns logits (B, T, padded_vocab) fp32, or the final normed hidden
        states (B, T, d) in the compute dtype when `return_hidden`."""
        t = idx.shape[1]
        seq = self.mesh.shape.get("seq", 1) if self.mesh is not None else 1
        if t * seq > self.cfg.block_size:
            raise ValueError(f"sequence {t * seq} exceeds block_size {self.cfg.block_size}")
        if not (isinstance(remat, bool) or remat in REMAT_MODES[2:]):
            raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
        if self.mesh is not None and "pipe" in self.mesh.shape:
            raise ValueError("a pipeline stage runs through parallel.pipeline")
        seeds = [None] * self.cfg.n_layer
        if generator is not None and self.cfg.lora_dropout > 0:
            seeds = torch.randint(0, 2**62, (self.cfg.n_layer,), generator=generator,
                                  device=generator.device).tolist()
        # a sequence shard's RoPE rows start at its offset
        off = self.seq_offset * t
        cos, sin = self.cos[off:off + t], self.sin[off:off + t]
        if self._fsdp_group is not None and remat in ("mlp", "moe"):
            remat = True  # a rematerialised piece must gather its leaves again
        x = self._embed(idx)
        for block, seed in zip(self.blocks, seeds):
            if not (remat and torch.is_grad_enabled()):
                x = self._call(block, block, x, cos, sin, seed=seed)
            elif remat == "mlp":
                x = block(x, cos, sin, seed=seed, mlp_remat=True)
            elif remat == "moe" and getattr(block.mlp, "impl", "dense") != "dense":
                x = block.forward_moe_remat(x, cos, sin, seed)
            else:
                x = checkpoint(self._call, block, block, x, cos, sin, seed=seed,
                               use_reentrant=False, preserve_rng_state=False)
        if return_hidden:
            return self._norm_f(x)
        return self._head(x)

    @torch.no_grad()
    def prefill(self, idx, lengths, cache):
        """Run the right-padded prompt (B, T), write its K/V at slot 0 of
        `cache`, and return the logits (B, V) fp32 at each row's last valid
        token (lengths - 1)."""
        x = self._embed(idx)
        for block, kv in zip(self.blocks, cache):
            x = self._call(block, block, x, self.cos, self.sin, cache_kv=kv)
        rows = torch.arange(x.shape[0], device=x.device)
        return self._head(x[rows, lengths.long() - 1])

    @torch.no_grad()
    def decode_step(self, token, positions, cache, active=None):
        """One step: token (B,) sits at slot `positions` (B,), its K/V is
        written there for the rows where `active` (B,) bool holds (all rows
        when None), and each row attends its first positions + 1 slots.
        Returns logits (B, V) fp32."""
        x = self._embed(token[:, None])
        kv_length = positions + 1
        for block, kv in zip(self.blocks, cache):
            x = self._call(block, block, x, self.cos, self.sin, cache_kv=kv,
                           positions=positions, kv_length=kv_length, active=active)
        return self._head(x[:, 0])

    @torch.no_grad()
    def verify_step(self, tokens, start, cache):
        """A speculative verify step (`verify_step` of the JAX package):
        tokens (B, K) sit at slots start..start+K-1 (start (B,)); all K
        tokens' K/V are written there in every row, and token i attends the
        slots at or below start + i. Returns logits (B, K, V) fp32, from one
        pass over the weights for all K tokens. RoPE rows are gathered at
        start + i in the activation dtype; past block_size they are NaN, as
        the JAX package's gather fills them."""
        x = self._embed(tokens)
        positions = start[:, None] + torch.arange(tokens.shape[1], device=tokens.device)
        cos, sin = rope_ops.gather_rope_rows(self.cos, self.sin, positions)
        for block, kv in zip(self.blocks, cache):
            x = self._call(block, block, x, cos, sin, cache_kv=kv, positions=start)
        return self._head(x)


@torch.no_grad()
def merge_lora(model: GPT) -> GPT:
    """Fold the LoRA deltas into the base weights in place and zero lora_B
    (`merge_lora` of the JAX package): the output is the same whether the
    LoRA branch runs afterwards or not. Block deltas (q/k/v, proj and the
    MLP's linears) are gated by `lora_start_layer`; the head's is not."""
    cfg = model.cfg
    if model.mesh is not None and model.mesh.shape.get("fsdp", 1) > 1:
        raise NotImplementedError("merge_lora under fsdp: merge on a one-rank model")

    def fold(mod, delta):
        if mod.quant is not None:
            raise ValueError("merge_lora needs the float weights: merge before quantizing")
        if mod.tp_kind is not None:
            # the piece of the whole delta that meets this rank's weight
            n = mod._local_extent()
            delta = delta.narrow(0 if mod.tp_kind == "col" else 1, mod.tp_index * n, n)
        mod.weight.copy_((mod.weight.float() + delta).to(mod.weight.dtype))
        mod.lora_B.zero_()

    for i, block in enumerate(model.blocks):
        gate = float(i >= cfg.lora_start_layer)
        qkv = block.attn.qkv
        if qkv.with_lora:
            r = cfg.lora_r
            outs, row = [], 0
            for j, extent in enumerate(qkv.shapes):
                outs.append(qkv.lora_B[row:row + extent] @ qkv.lora_A[j * r:(j + 1) * r])
                row += extent
            delta = torch.cat(outs) * cfg.lora_scaling
            if len(qkv.shapes) < 3:
                full = torch.zeros((cfg.qkv_out_dim, cfg.n_embd), dtype=delta.dtype,
                                   device=delta.device)
                full[qkv.rows] = delta
                delta = full
            fold(qkv, delta * gate)
        for lin in (block.attn.proj, *block.mlp.children()):
            if getattr(lin, "with_lora", False):
                fold(lin, (lin.lora_B @ lin.lora_A) * cfg.lora_scaling * gate)
    if model.lm_head.with_lora:
        fold(model.lm_head, (model.lm_head.lora_B @ model.lm_head.lora_A) * cfg.lora_scaling)
    return model


@torch.no_grad()
def quantize_model(model: GPT, mode: str) -> GPT:
    """Quantize the model's big linear weights in place (`quantize_tree` of
    the JAX package on its tree): "int8" per row, "int4" group-wise where the
    input width is a multiple of 128 (int8 elsewhere); the embedding, the
    norms and matrices under 256 wide stay as they are. An MoE model raises:
    the JAX package's `quantize_tree` quantizes the expert stacks, but its
    `_moe_mlp` and `_moe_mlp_sparse` read only their float weights."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantization mode {mode!r} not in ('int8', 'int4')")
    if model.cfg.mlp_class == "LLaMAMoE":
        raise NotImplementedError(
            "a quantized MoE is not supported: the JAX package's MoE reads only the "
            "expert stacks' float weights (gpt._moe_mlp, _moe_mlp_sparse)")
    if model.mesh is not None and model.mesh.shape.get("fsdp", 1) > 1:
        raise NotImplementedError("quantized weights under fsdp: quantize a one-rank model")
    for mod in model.modules():
        if not (isinstance(mod, _Frozen) and mod.quant is None):
            continue
        w = mod.weight
        # the decisions of the whole weight; a tensor-parallel piece's
        # values are those of the whole weight's quantization
        n = comm.size(mod.tp_group)
        whole = sharding._Shape((w.shape[0] * (n if mod.tp_kind == "col" else 1),
                                 w.shape[1] * (n if mod.tp_kind == "row" else 1)))
        if not quant_ops._should_quantize("weight", whole):
            continue
        int4 = mode == "int4" and whole.shape[1] % quant_ops.INT4_GROUP == 0
        if mod.tp_kind == "row" and (int4 and w.shape[1] % quant_ops.INT4_GROUP):
            raise ValueError(f"a row-parallel in dim of {w.shape[1]} splits int4's groups "
                             f"of {quant_ops.INT4_GROUP}")
        absmax = None
        if mod.tp_kind == "row" and not int4:
            # int8 scales a whole row: its absmax over the tensor ranks
            absmax = w.abs().amax(dim=-1, keepdim=True).float()
            comm.all_reduce_(absmax, mod.tp_group, torch.distributed.ReduceOp.MAX)
            absmax = absmax.to(w.dtype)
        mod.set_quantized(quant_ops.quantize_pair(w, "int4" if int4 else "int8", absmax))
    return model
