"""RelPrompt reliability classifiers and the vocabulary extension.

Counterpart of `dualhyp_tpu/models/relprompt.py`: the noise-mask classifier
(two Conv1d(k=3, pad=1) + ReLU, dropout after the first, AvgPool1d(pool,
ceil_mode=True) over the valid elements of the last window, a linear to 3
classes) and the embedding rows appended for `<<C>>`/`<<M>>`/`<<N>>`,
drawn N(0, std(existing rows)). `lm_head` keeps its rows: the mask tokens
are inputs, never outputs.

The parameters are the JAX package's trees: `{"conv1": {"weight", "bias"},
"conv2": ..., "classifier": ...}` per classifier. A RelPrompt `GPT` holds
its two as `NoiseClassifier` modules named `audio_noise_classifier` and
`visual_noise_classifier`, so `ckpt.convert.load_tree` and `tree_from_model`
read and write them under the JAX package's keys. The convolutions are
plain PyTorch (cuDNN), in fp32 with TF32 off (`device.exact_fp32`), as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dualhyp_tpu_torch.device import exact_fp32

NUM_CLASSES = 3  # <<C>>, <<M>>, <<N>>


def _uniform(shape, bound: float, generator, device):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (2 * bound) - bound).to(device)


def init_classifier(generator: torch.Generator, input_dim: int, hidden_dim: int = 256,
                    device=None) -> dict:
    """Torch Conv1d/Linear default bounds (kaiming-uniform over fan_in), zero
    biases, fp32, drawn from `generator`."""
    device = generator.device if device is None else torch.device(device)

    def conv(out_c, in_c, width):
        bound = 1.0 / math.sqrt(in_c * width)
        return {"weight": _uniform((out_c, in_c, width), bound, generator, device),
                "bias": torch.zeros(out_c, device=device)}

    bound = 1.0 / math.sqrt(hidden_dim)
    return {
        "conv1": conv(hidden_dim, input_dim, 3),
        "conv2": conv(hidden_dim, hidden_dim, 3),
        "classifier": {"weight": _uniform((NUM_CLASSES, hidden_dim), bound, generator, device),
                       "bias": torch.zeros(NUM_CLASSES, device=device)},
    }


def _conv1d(x, w, b):
    # x: (B, C_in, T); w: (C_out, C_in, K) -> (B, C_out, T), padding=1
    return F.conv1d(x, w.to(x.dtype), b.to(x.dtype), padding=1)


def _avg_pool_ceil(x, pool: int):
    """AvgPool1d(kernel=pool, stride=pool, ceil_mode=True): the trailing
    partial window averages over its valid elements only."""
    b, c, t = x.shape
    n_out = -(-t // pool)
    xp = F.pad(x, (0, n_out * pool - t))
    sums = xp.reshape(b, c, n_out, pool).sum(-1)
    starts = torch.arange(n_out, device=x.device) * pool
    counts = torch.clamp(starts + pool, max=t) - starts
    return sums / counts.to(x.dtype)


def _dropout_keep(shape, rate: float, generator, device):
    """The elements dropout keeps, each with probability 1 - rate."""
    return torch.rand(shape, generator=generator, device=generator.device).to(device) >= rate


def classifier_forward(params: dict, x, pool: int, *, generator=None,
                       dropout: float = 0.1):
    """x: (B, T, C) encoder features -> (B, ceil(T/pool), 3) logits. With a
    generator, dropout after the first convolution (training)."""
    with exact_fp32():
        h = x.transpose(1, 2)  # (B, C, T)
        h = F.relu(_conv1d(h, params["conv1"]["weight"], params["conv1"]["bias"]))
        if generator is not None and dropout > 0:
            keep = _dropout_keep(h.shape, dropout, generator, h.device)
            h = torch.where(keep, h / (1.0 - dropout), 0.0).to(h.dtype)
        h = F.relu(_conv1d(h, params["conv2"]["weight"], params["conv2"]["bias"]))
        h = _avg_pool_ceil(h, pool).transpose(1, 2)  # (B, T_out, hidden)
        w = params["classifier"]["weight"].to(h.dtype)
        return h @ w.t() + params["classifier"]["bias"]


class NoiseClassifier(nn.Module):
    """One classifier's parameters as a module (fp32, frozen until a
    trainer turns them on), with `tree()` the JAX package's dict of them."""

    def __init__(self, input_dim: int, hidden_dim: int, device=None):
        super().__init__()
        shapes = {"conv1": (hidden_dim, input_dim, 3), "conv2": (hidden_dim, hidden_dim, 3),
                  "classifier": (NUM_CLASSES, hidden_dim)}
        for name, shape in shapes.items():
            layer = nn.Module()
            layer.weight = nn.Parameter(torch.empty(shape, device=device), requires_grad=False)
            layer.bias = nn.Parameter(torch.empty(shape[0], device=device), requires_grad=False)
            self.add_module(name, layer)

    def tree(self) -> dict:
        return {name: {"weight": layer.weight, "bias": layer.bias}
                for name, layer in self.named_children()}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        cfg = self.conv1.weight.shape
        tree = init_classifier(generator, cfg[1], cfg[0], device=self.conv1.weight.device)
        for name, leaves in tree.items():
            layer = getattr(self, name)
            layer.weight.copy_(leaves["weight"])
            layer.bias.copy_(leaves["bias"])

    def forward(self, x, pool: int, generator=None, dropout: float = 0.1):
        return classifier_forward(self.tree(), x, pool, generator=generator, dropout=dropout)


def init_relprompt_params(cfg, generator: torch.Generator, *, device=None,
                          dtype=torch.bfloat16):
    """The full RelPrompt model, random from `generator`: the LoRA GPT with
    its two classifiers (audio over Whisper features, pooled by
    2 * classifier_pool_size for their 50 frames a second; visual over
    BRAVEn features, pooled by classifier_pool_size at 25)."""
    from dualhyp_tpu_torch.models.gpt import GPT

    model = GPT(cfg, device=device, dtype=dtype)
    model.init_weights(generator)
    return model


def extend_embeddings(params: dict, generator: torch.Generator, n_extra: int = 3) -> dict:
    """The tree with `n_extra` rows appended to `wte`, drawn
    N(0, std(existing rows)) from `generator` (the JAX package's
    `extend_embeddings`). The other leaves are shared, not copied."""
    from dualhyp_tpu_torch.ckpt.convert import _tensor

    wte = _tensor(params["wte"]["weight"])
    std = wte.float().std(unbiased=False)
    extra = torch.randn((n_extra, wte.shape[1]), generator=generator,
                        device=generator.device).to(wte.device) * std
    new = dict(params)
    new["wte"] = {"weight": torch.cat([wte, extra.to(wte.dtype)], dim=0)}
    return new


@torch.no_grad()
def init_relprompt_leaves(model, generator: torch.Generator) -> None:
    """A RelPrompt `GPT`'s new leaves, in place, as the JAX package's
    finetuning starts them: the audio, then the visual classifier
    (`init_classifier`), then the `n_extra_tokens` embedding rows above the
    base vocabulary, N(0, std(the base rows)) as `extend_embeddings` draws
    them, all from `generator`."""
    model.audio_noise_classifier.init_weights(generator)
    model.visual_noise_classifier.init_weights(generator)
    n_extra = model.cfg.n_extra_tokens
    wte = model.wte.weight
    base = {"wte": {"weight": wte[:wte.shape[0] - n_extra]}}
    wte.copy_(extend_embeddings(base, generator, n_extra)["wte"]["weight"])


def mask_loss(logits, targets) -> torch.Tensor:
    """3-class cross-entropy with length trimming."""
    t = min(logits.shape[1], targets.shape[1])
    logits = logits[:, :t].float()
    targets = targets[:, :t].long()
    logz = torch.logsumexp(logits, dim=-1)
    gathered = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gathered).mean()


def mask_metrics(predictions, targets) -> dict:
    """Accuracy and binary noise-detection precision, recall, F1 (classes
    {M, N} against C)."""
    preds = np.asarray(predictions).ravel()
    targs = np.asarray(targets).ravel()
    acc = float((preds == targs).mean()) if preds.size else 0.0
    pred_noise = preds > 0
    targ_noise = targs > 0
    tp = int((pred_noise & targ_noise).sum())
    fp = int((pred_noise & ~targ_noise).sum())
    fn = int((~pred_noise & targ_noise).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {"acc": acc, "precision": precision, "recall": recall, "f1": f1}
