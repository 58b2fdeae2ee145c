"""Decoder-only GPT of the LLaMA family, with LoRA: finetuning and decoding.

Counterpart of `dualhyp_tpu/models/gpt.py`: RMSNorm, the
LLaMA (silu) or Gemma (tanh-gelu) gated MLP, grouped-query attention, full
or partial rotary embeddings, no bias; LoRA on the fused QKV projection and
on `proj` (and on the head when asked), gated by `lora_start_layer`.

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
trainer may round them to its frozen dtype). The LoRA leaves are fp32
masters, cast to the activation dtype at each use as the JAX package casts
its leaves: an AdamW step of ~1e-4 x lr would round away in bf16.

`forward` is the training and evaluation pass (grad enabled; LoRA-input
dropout from a generator; whole-block rematerialisation with
`torch.utils.checkpoint`); `prefill` and `decode_step` serve, without grad.
Every parameter is created with requires_grad False; a trainer turns it on
for `trainable_parameters()`.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.device import resolve_device
from dualhyp_tpu_torch.ops import attention as attn_ops
from dualhyp_tpu_torch.ops import rmsnorm as norm_ops
from dualhyp_tpu_torch.ops import rope as rope_ops
from dualhyp_tpu_torch.ops import swiglu as mlp_ops


def check_supported(cfg: GPTConfig) -> None:
    """Raise for the parts of a config this module does not port yet."""
    missing = []
    if cfg.norm_class != "RMSNorm":
        missing.append(f"norm_class={cfg.norm_class}")
    if cfg.mlp_class not in ("LLaMAMLP", "GemmaMLP"):
        missing.append(f"mlp_class={cfg.mlp_class}")
    if cfg.bias or cfg.lm_head_bias:
        missing.append("bias")
    if cfg.use_adapter or cfg.use_adapter_v2:
        missing.append("adapters")
    if cfg.lora_r > 0 and cfg.lora_mlp:
        missing.append("LoRA on the MLP")
    if cfg.use_relprompt:
        missing.append("RelPrompt")
    if missing:
        raise NotImplementedError(
            f"config {cfg.name!r} asks for what is not ported yet: {', '.join(missing)}"
        )


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


def _dropout(x, rate: float, generator):
    """LoRA-input dropout (`_dropout` of the JAX package): each element kept
    with probability 1 - rate and scaled by 1 / (1 - rate)."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class Norm(nn.Module):
    def __init__(self, d, device):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)


class Embedding(nn.Module):
    def __init__(self, n, d, dtype, device):
        super().__init__()
        self.weight = _param((n, d), dtype, device)


class Linear(nn.Module):
    """torch-layout linear with an optional LoRA branch.

    As `_apply_linear` of the JAX package: the fp32 A and B are cast to x's
    dtype, the two products run in it on the dropped-out input, and then
    come the scaling and the layer gate (a gated-off layer skips the branch,
    whose leaves then get no gradient: zero, as the JAX gate's)."""

    def __init__(self, in_f, out_f, cfg: GPTConfig, with_lora: bool, dtype, device):
        super().__init__()
        self.scaling = cfg.lora_scaling
        self.dropout = cfg.lora_dropout
        self.weight = _param((out_f, in_f), dtype, device)
        self.with_lora = with_lora and cfg.lora_r > 0
        if self.with_lora:
            self.lora_A = _param((cfg.lora_r, in_f), torch.float32, device)
            self.lora_B = _param((out_f, cfg.lora_r), torch.float32, device)

    def forward(self, x, lora_on: bool = True, generator=None):
        y = mlp_ops.linear(x, self.weight)
        if self.with_lora and lora_on:
            xin = _dropout(x, self.dropout, generator)
            delta = (xin @ self.lora_A.to(x.dtype).t()) @ self.lora_B.to(x.dtype).t()
            y = y + delta * self.scaling
        return y


class QKV(nn.Module):
    """Fused QKV projection with the reference's LoRA arithmetic
    (`_apply_qkv` of the JAX package)."""

    def __init__(self, cfg: GPTConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_embd
        self.weight = _param((cfg.qkv_out_dim, d), dtype, device)
        self.shapes = lora_qkv_shapes(cfg) if cfg.lora_r > 0 else ()
        self.with_lora = bool(self.shapes)
        if self.with_lora:
            self.lora_A = _param((cfg.lora_r * len(self.shapes), d), torch.float32, device)
            self.lora_B = _param((sum(self.shapes), cfg.lora_r), torch.float32, device)
            if len(self.shapes) < 3:
                self.register_buffer("rows", lora_qkv_row_index(cfg).to(device),
                                     persistent=False)

    def forward(self, x, lora_on: bool = True, generator=None):
        y = mlp_ops.linear(x, self.weight)
        if not (self.with_lora and lora_on):
            return y
        r = self.cfg.lora_r
        xin = _dropout(x, self.cfg.lora_dropout, generator)
        after_a = xin @ self.lora_A.to(x.dtype).t()
        lora_b = self.lora_B.to(x.dtype)
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
            padded = torch.zeros_like(y)
            padded[..., self.rows] = delta.to(y.dtype)
        return y + padded.to(y.dtype)


def split_heads(cfg: GPTConfig, qkv):
    """(B, T, QKV) -> q (B, G, q_per_kv, T, D), k, v (B, G, T, D), all views.

    The fused layout interleaves per query group: [q * q_per_kv, k, v]."""
    b, t, _ = qkv.shape
    g, qpk, hs = cfg.n_query_groups, cfg.q_per_kv, cfg.head_size
    qkv = qkv.view(b, t, g, qpk + 2, hs)
    q = qkv[:, :, :, :qpk].permute(0, 2, 3, 1, 4)
    k = qkv[:, :, :, qpk].transpose(1, 2)
    v = qkv[:, :, :, qpk + 1].transpose(1, 2)
    return q, k, v


class Attention(nn.Module):
    def __init__(self, cfg: GPTConfig, dtype, device):
        super().__init__()
        self.qkv = QKV(cfg, dtype, device)
        self.proj = Linear(cfg.n_embd, cfg.n_embd, cfg, cfg.lora_projection,
                           dtype, device)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig, dtype, device):
        super().__init__()
        d, inter = cfg.n_embd, cfg.intermediate_size
        self.gate = "silu" if cfg.mlp_class == "LLaMAMLP" else "gelu"
        self.fc_1 = Linear(d, inter, cfg, False, dtype, device)
        self.fc_2 = Linear(d, inter, cfg, False, dtype, device)
        self.proj = Linear(inter, d, cfg, False, dtype, device)

    def forward(self, x):
        return mlp_ops.swiglu_mlp(x, self.fc_1.weight, self.fc_2.weight,
                                  self.proj.weight, gate=self.gate)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, layer_idx: int, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.lora_on = layer_idx >= cfg.lora_start_layer
        self.norm_1 = Norm(cfg.n_embd, device)
        self.attn = Attention(cfg, dtype, device)
        if not cfg.shared_attention_norm:
            self.norm_2 = Norm(cfg.n_embd, device)
        self.mlp = MLP(cfg, dtype, device)

    def _norm(self, norm: Norm, x):
        return norm_ops.rms_norm(x, norm.scale, self.cfg.norm_eps)

    def forward(self, x, cos, sin, cache_kv=None, positions=None,
                kv_length=None, active=None, seed=None):
        """x: (B, T, d). cache_kv: this layer's (k, v) cache, written in
        place: at slot 0 in prefill (positions None), at `positions` in a
        decode step (T == 1), for the rows where `active` holds. seed: the
        LoRA dropout masks of this block come from a generator seeded with
        it, so a rematerialised pass draws the same masks (None: no
        dropout)."""
        cfg = self.cfg
        b, t, _ = x.shape
        nh, hs = cfg.n_head, cfg.head_size
        generator = None
        if seed is not None:
            generator = torch.Generator(device=x.device)
            generator.manual_seed(seed)
        n1 = self._norm(self.norm_1, x)
        qkv = self.attn.qkv(n1, self.lora_on, generator)
        q, k, v = split_heads(cfg, qkv)
        if positions is None:
            q = rope_ops.apply_rope(q, cos[:t], sin[:t]).reshape(b, nh, t, hs)
            k = rope_ops.apply_rope(k, cos[:t], sin[:t])
        else:
            if t != 1:
                raise NotImplementedError("chunked decode is not ported yet")
            q = rope_ops.apply_rope_gathered(q.reshape(b, nh, t, hs), cos, sin, positions)
            k = rope_ops.apply_rope_gathered(k, cos, sin, positions)

        if cache_kv is None:
            y = attn_ops.causal_attention(q, k, v)
        elif positions is None:
            # prefill: the whole prompt goes to slot 0; attention reads the
            # exact k, v
            ck, cv = cache_kv
            ck[:, :, :t] = k
            cv[:, :, :t] = v
            y = attn_ops.causal_attention(q, k, v)
        else:
            ck, cv = cache_kv
            rows = torch.arange(b, device=x.device)
            k_new, v_new = k[:, :, 0].to(ck.dtype), v[:, :, 0].to(cv.dtype)
            if active is not None:
                # an inactive row writes back what its slot holds (a blend,
                # not a boolean index: no wait on the device)
                keep = ~active[:, None, None]
                k_new = torch.where(keep, ck[rows, :, positions], k_new)
                v_new = torch.where(keep, cv[rows, :, positions], v_new)
            ck[rows, :, positions] = k_new
            cv[rows, :, positions] = v_new
            y = attn_ops.decode_attention(q, ck, cv, kv_length)

        y = y.transpose(1, 2).reshape(b, t, nh * hs)
        h = self.attn.proj(y, self.lora_on, generator)
        if cfg.parallel_residual:
            n2 = n1 if cfg.shared_attention_norm else self._norm(self.norm_2, x)
            return x + h + self.mlp(n2)
        x = x + h
        return x + self.mlp(self._norm(self.norm_2, x))


class GPT(nn.Module):
    """The model. `device=None` means the card, and raises without one."""

    def __init__(self, cfg: GPTConfig, *, device=None, dtype=torch.bfloat16):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.wte = Embedding(cfg.effective_padded_vocab_size, cfg.n_embd, dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg, i, dtype, device) for i in range(cfg.n_layer))
        self.ln_f = Norm(cfg.n_embd, device)
        self.lm_head = Linear(cfg.n_embd, cfg.padded_vocab_size, cfg,
                              cfg.lora_head, dtype, device)
        cos, sin = rope_ops.build_rope_cache(
            cfg.block_size, cfg.rope_n_elem, base=cfg.rope_base,
            condense_ratio=cfg.rope_condense_ratio, dtype=dtype, device=device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random init with the JAX package's distributions (`gpt.init`):
        normal weights (GPT-NeoX std), uniform lora_A, zero lora_B, unit
        norm scales. Draws in fp32 from `generator`, then casts."""
        cfg = self.cfg
        d = cfg.n_embd
        std = math.sqrt(2.0 / 5 / d)
        proj_std = 1.0 / math.sqrt(d) / cfg.n_layer

        def normal(p, s):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * s)

        def lora(mod):
            if mod.with_lora:
                bound = 1.0 / math.sqrt(mod.lora_A.shape[1])
                a = torch.rand(mod.lora_A.shape, generator=generator, device=mod.lora_A.device)
                mod.lora_A.copy_(a * (2 * bound) - bound)
                mod.lora_B.zero_()

        normal(self.wte.weight, std)
        normal(self.lm_head.weight, std)
        lora(self.lm_head)
        self.ln_f.scale.fill_(1.0)
        for block in self.blocks:
            block.norm_1.scale.fill_(1.0)
            if hasattr(block, "norm_2"):
                block.norm_2.scale.fill_(1.0)
            normal(block.attn.qkv.weight, std)
            lora(block.attn.qkv)
            normal(block.attn.proj.weight, proj_std)
            lora(block.attn.proj)
            normal(block.mlp.fc_1.weight, std)
            normal(block.mlp.fc_2.weight, std)
            normal(block.mlp.proj.weight, proj_std)

    def _embed(self, idx):
        x = self.wte.weight[idx]
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(self.cfg.n_embd), dtype=x.dtype)
        return x

    def _head(self, x):
        x = norm_ops.rms_norm(x, self.ln_f.scale, self.cfg.norm_eps)
        return self.lm_head(x).float()

    def init_cache(self, batch_size: int, max_seq: int) -> list:
        """Per-layer [k, v] caches, each (B, G, S, D) zeros in the compute
        dtype. Only the n_query_groups KV heads are stored."""
        cfg = self.cfg
        shape = (batch_size, cfg.n_query_groups, max_seq, cfg.head_size)
        return [
            [torch.zeros(shape, dtype=self.dtype, device=self.device) for _ in range(2)]
            for _ in range(cfg.n_layer)
        ]

    def trainable_parameters(self) -> dict:
        """The LoRA leaves (`trainable_mask` of the JAX package in mode
        "lora"), by parameter name."""
        return {name: p for name, p in self.named_parameters()
                if name.rsplit(".", 1)[-1].startswith("lora_")}

    def count_params(self, trainable_only: bool = False) -> int:
        params = (self.trainable_parameters().values() if trainable_only
                  else self.parameters())
        return sum(p.numel() for p in params)

    def forward(self, idx, *, generator=None, remat=False, return_hidden=False):
        """Training and evaluation pass, grad enabled. idx: (B, T) token ids.

        generator: draws one seed per block for the LoRA-input dropout (a
        CPU generator keeps the draw off the card's queue); None means no
        dropout. remat: True rematerialises each block in the
        backward (`torch.utils.checkpoint`). Returns logits
        (B, T, padded_vocab) fp32, or the final normed hidden states
        (B, T, d) in the compute dtype when `return_hidden`."""
        t = idx.shape[1]
        if t > self.cfg.block_size:
            raise ValueError(f"sequence {t} exceeds block_size {self.cfg.block_size}")
        if not isinstance(remat, bool):
            raise NotImplementedError(f"remat={remat!r} is not ported yet")
        seeds = [None] * self.cfg.n_layer
        if generator is not None and self.cfg.lora_dropout > 0:
            seeds = torch.randint(0, 2**62, (self.cfg.n_layer,), generator=generator,
                                  device=generator.device).tolist()
        x = self._embed(idx)
        for block, seed in zip(self.blocks, seeds):
            if remat and torch.is_grad_enabled():
                x = checkpoint(block, x, self.cos, self.sin, seed=seed,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, self.cos, self.sin, seed=seed)
        if return_hidden:
            return norm_ops.rms_norm(x, self.ln_f.scale, self.cfg.norm_eps)
        return self._head(x)

    @torch.no_grad()
    def prefill(self, idx, lengths, cache):
        """Run the right-padded prompt (B, T), write its K/V at slot 0 of
        `cache`, and return the logits (B, V) fp32 at each row's last valid
        token (lengths - 1)."""
        x = self._embed(idx)
        for block, kv in zip(self.blocks, cache):
            x = block(x, self.cos, self.sin, cache_kv=kv)
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
            x = block(x, self.cos, self.sin, cache_kv=kv, positions=positions,
                      kv_length=kv_length, active=active)
        return self._head(x[:, 0])
