"""Model configuration.

A copy of `dualhyp_tpu/config.py`, kept in this package so that the port
imports nothing of the JAX package. Mirrors the semantics of the reference
config (ref: ger/config.py:16-157): derived `padded_vocab_size` (round up to
`padding_multiple`), `head_size`, `rope_n_elem`, GQA via `n_query_groups`,
norm/MLP class selection. The dataclass is frozen, so a config is hashable
and safe to share between models.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


def round_up_multiple(n: int, k: int) -> int:
    """Smallest multiple of `k` that is >= `n` (ref: ger/utils.py:29)."""
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class GPTConfig:
    """Decoder-only transformer configuration.

    Defaults follow the reference base config (ref: ger/config.py:17-64).
    PEFT fields (LoRA / adapter / RelPrompt) live on the same config so a
    single frozen object describes the full model variant, mirroring how the
    reference subclasses Config per variant (ref: ger/lora.py:446-472,
    ger/adapter.py:21-24, ger/relprompt.py:150-179).
    """

    name: str = ""
    block_size: int = 4096
    vocab_size: int = 50254
    padding_multiple: int = 512
    padded_vocab_size: Optional[int] = None
    n_layer: int = 16
    n_head: int = 32
    head_size: Optional[int] = None
    n_embd: int = 4096
    rotary_percentage: float = 0.25
    parallel_residual: bool = True
    bias: bool = True
    lm_head_bias: bool = False
    n_query_groups: Optional[int] = None
    shared_attention_norm: bool = False
    norm_class: str = "LayerNorm"  # "LayerNorm" | "RMSNorm"
    norm_eps: float = 1e-5
    mlp_class: str = "GptNeoxMLP"  # "GptNeoxMLP" | "LLaMAMLP" | "GemmaMLP" | "LLaMAMoE"
    gelu_approximate: str = "none"
    intermediate_size: Optional[int] = None
    rope_condense_ratio: int = 1
    rope_base: int = 10000
    scale_embeddings: bool = False
    n_expert: int = 0
    n_expert_per_token: int = 0

    # ---- PEFT: LoRA (ref: ger/lora.py:446-472) ----
    lora_r: int = 0
    lora_alpha: int = 1
    lora_dropout: float = 0.0
    lora_query: bool = False
    lora_key: bool = False
    lora_value: bool = False
    lora_projection: bool = False
    lora_mlp: bool = False
    lora_head: bool = False
    lora_start_layer: int = 0

    # ---- PEFT: adapter v1/v2 (ref: ger/adapter.py:21-24) ----
    use_adapter: bool = False
    use_adapter_v2: bool = False
    adapter_prompt_length: int = 10
    adapter_start_layer: int = 2

    # ---- RelPrompt classifiers (ref: ger/relprompt.py:163-175) ----
    use_relprompt: bool = False
    n_extra_tokens: int = 0  # appended embedding rows (<<C>>/<<M>>/<<N>>)
    whisper_dim: int = 1280
    raven_dim: int = 1024
    classifier_pool_size: int = 10
    classifier_hidden_dim: int = 256
    classifier_dropout: float = 0.1

    def __post_init__(self):
        if self.head_size is None:
            assert self.n_embd % self.n_head == 0
            object.__setattr__(self, "head_size", self.n_embd // self.n_head)
        if self.padded_vocab_size is None:
            object.__setattr__(
                self,
                "padded_vocab_size",
                round_up_multiple(self.vocab_size, self.padding_multiple),
            )
        else:
            object.__setattr__(
                self, "vocab_size", min(self.vocab_size, self.padded_vocab_size)
            )
        if self.n_query_groups is None:
            object.__setattr__(self, "n_query_groups", self.n_head)
        else:
            assert self.n_head % self.n_query_groups == 0
        if self.intermediate_size is None:
            if self.mlp_class == "LLaMAMLP":
                raise ValueError("LLaMAMLP requires an explicit intermediate_size")
            object.__setattr__(self, "intermediate_size", 4 * self.n_embd)

    # ---- derived ----
    @property
    def rope_n_elem(self) -> int:
        return int(self.rotary_percentage * self.head_size)

    @property
    def q_per_kv(self) -> int:
        return self.n_head // self.n_query_groups

    @property
    def qkv_out_dim(self) -> int:
        # fused QKV projection width: per group, q_per_kv queries + 1 key + 1 value
        # (ref: ger/model.py:194)
        return (self.n_head + 2 * self.n_query_groups) * self.head_size

    @property
    def kv_embd_size(self) -> int:
        return self.n_query_groups * self.head_size

    @property
    def effective_padded_vocab_size(self) -> int:
        """Vocab rows including RelPrompt special-token extension."""
        return self.padded_vocab_size + self.n_extra_tokens

    @property
    def any_lora(self) -> bool:
        return self.lora_r > 0 and any(
            (
                self.lora_query,
                self.lora_key,
                self.lora_value,
                self.lora_projection,
                self.lora_mlp,
                self.lora_head,
            )
        )

    @property
    def enable_lora_qkv(self) -> tuple:
        return (self.lora_query, self.lora_key, self.lora_value)

    @property
    def lora_scaling(self) -> float:
        return self.lora_alpha / self.lora_r if self.lora_r > 0 else 0.0

    def replace(self, **kwargs) -> "GPTConfig":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, path) -> "GPTConfig":
        """Load a config from a JSON file (ref: ger/config.py:111-124).

        Accepts both our field names and the reference's lit_config.json field
        names (`_norm_class`, `_mlp_class`, `hf_config`, `condense_ratio`).
        """
        with open(Path(path), encoding="utf-8") as fp:
            raw = json.load(fp)
        return cls(**normalize_config_fields(raw))


# mapping from reference lit_config.json keys to our field names
_LEGACY_KEYS = {
    "_norm_class": "norm_class",
    "_mlp_class": "mlp_class",
    "condense_ratio": "rope_condense_ratio",
}
_LORA_LEGACY = {
    "r": "lora_r",
    "alpha": "lora_alpha",
    "dropout": "lora_dropout",
    "to_query": "lora_query",
    "to_key": "lora_key",
    "to_value": "lora_value",
    "to_projection": "lora_projection",
    "to_mlp": "lora_mlp",
    "to_head": "lora_head",
}
_DROPPED_KEYS = {"hf_config", "org"}
_VALID_FIELDS = {f.name for f in dataclasses.fields(GPTConfig)}


def normalize_config_fields(raw: dict) -> dict:
    """Translate reference-style config dicts into GPTConfig kwargs."""
    out = {}
    for key, value in raw.items():
        key = _LEGACY_KEYS.get(key, key)
        key = _LORA_LEGACY.get(key, key)
        if key in _DROPPED_KEYS:
            continue
        if key not in _VALID_FIELDS:
            continue
        out[key] = value
    return out
