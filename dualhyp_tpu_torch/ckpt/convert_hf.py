"""HF checkpoint directory -> the JAX package's parameter tree.

Counterpart of `dualhyp_tpu/ckpt/convert_hf.py`, with the same arithmetic:
the separate HF q/k/v projections interleave into one fused per-group QKV
weight (per query group, q_per_kv query-head row blocks, then one K and one
V block), the vocabulary rows pad to `padded_vocab_size`, and per-layer
tensors stack on a leading (n_layer, ...) axis. Four families convert:

  * LLaMA (TinyLlama, Llama-2/3, Mistral; Mixtral's `block_sparse_moe`
    router and experts: w1 -> fc_1, w3 -> fc_2, w2 -> proj, stacked
    (n_layer, n_expert, out, in));
  * GPT-NeoX (Pythia, Dolly v2, RedPajama-INCITE, StableLM-alpha,
    StableCode): the fused `query_key_value` ships per head as (q, k, v),
    which is the per-group layout for MHA; LayerNorms with biases, the
    `fc` / `proj` MLP;
  * Falcon: the fused QKV ships in the target layout; 7b (MQA) has one
    shared `input_layernorm`, 40b and 180B (grouped) `ln_attn` and `ln_mlp`;
    no biases;
  * Phi (phi-1_5, phi-2): separate q/k/v with biases, `dense`, `fc1`/`fc2`,
    one LayerNorm a layer, a biased head.

Shards are read with `ckpt.io.load_safetensors` (the card's machine has no
`safetensors` package); the tree's leaves are CPU torch tensors in their
stored dtype, cast with torch when a dtype is asked for. `load_tree` and
`ckpt.io.save_params` take such a tree as they take the JAX package's.

    python -m dualhyp_tpu_torch.ckpt.convert_hf --checkpoint_dir <hf dir> \
        [--model_name tiny-llama-1.1b-chat] [--out <npz>] [--dtype bfloat16]

writes `dualhyp_model.npz` (or --out) and `dualhyp_config.json` beside it.
"""

from __future__ import annotations

from pathlib import Path

import torch

from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.registry import config_from_name

def interleave_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: GPTConfig) -> torch.Tensor:
    """Separate (out, in) q/k/v weights -> the fused interleaved layout."""
    hs = cfg.head_size
    qs = torch.split(q, hs * cfg.q_per_kv)
    ks = torch.split(k, hs)
    vs = torch.split(v, hs)
    assert len(qs) == len(ks) == len(vs) == cfg.n_query_groups
    return torch.cat([x for g in range(cfg.n_query_groups) for x in (qs[g], ks[g], vs[g])])


def split_qkv(fused: torch.Tensor, cfg: GPTConfig):
    """Inverse of `interleave_qkv` (for exporting back to HF)."""
    hs = cfg.head_size
    groups = fused.reshape(cfg.n_query_groups, hs * (cfg.q_per_kv + 2), *fused.shape[1:])
    q, k, v = torch.split(groups, [hs * cfg.q_per_kv, hs, hs], dim=1)
    return (q.reshape(-1, *fused.shape[1:]), k.reshape(-1, *fused.shape[1:]),
            v.reshape(-1, *fused.shape[1:]))


def load_hf_tensors(checkpoint_dir) -> dict:
    """{name: CPU tensor} of every `*.safetensors` shard of the directory."""
    from dualhyp_tpu_torch.ckpt.io import load_safetensors

    shards = sorted(Path(checkpoint_dir).glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files in {checkpoint_dir}")
    tensors = {}
    for shard in shards:
        tensors.update(load_safetensors(shard))
    return tensors


def _pad_vocab(w: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    if w.shape[0] < cfg.padded_vocab_size:
        pad = w.new_zeros((cfg.padded_vocab_size - w.shape[0], *w.shape[1:]))
        return torch.cat([w, pad])
    return w[: cfg.padded_vocab_size]


def convert_llama_family(hf: dict, cfg: GPTConfig) -> dict:
    n = cfg.n_layer

    def stacked(name):
        return torch.stack([hf[f"model.layers.{i}.{name}"] for i in range(n)])

    def experts(w):
        return torch.stack([
            torch.stack([hf[f"model.layers.{i}.block_sparse_moe.experts.{x}.{w}.weight"]
                         for x in range(cfg.n_expert)])
            for i in range(n)])

    qkv = torch.stack([
        interleave_qkv(*(hf[f"model.layers.{i}.self_attn.{p}_proj.weight"] for p in "qkv"),
                       cfg)
        for i in range(n)])
    if cfg.mlp_class == "LLaMAMoE":
        mlp = {"gate": {"weight": stacked("block_sparse_moe.gate.weight")},
               "fc_1": {"weight": experts("w1")},
               "fc_2": {"weight": experts("w3")},
               "proj": {"weight": experts("w2")}}
    else:
        mlp = {"fc_1": {"weight": stacked("mlp.gate_proj.weight")},
               "fc_2": {"weight": stacked("mlp.up_proj.weight")},
               "proj": {"weight": stacked("mlp.down_proj.weight")}}
    lm_head = hf.get("lm_head.weight", hf["model.embed_tokens.weight"])
    return {
        "wte": {"weight": _pad_vocab(hf["model.embed_tokens.weight"], cfg)},
        "ln_f": {"scale": hf["model.norm.weight"]},
        "lm_head": {"weight": _pad_vocab(lm_head, cfg)},
        "blocks": {
            "norm_1": {"scale": stacked("input_layernorm.weight")},
            "norm_2": {"scale": stacked("post_attention_layernorm.weight")},
            "attn": {"qkv": {"weight": qkv},
                     "proj": {"weight": stacked("self_attn.o_proj.weight")}},
            "mlp": mlp,
        },
    }


def _layer_norm(get):
    """The {scale, bias} leaves of a LayerNorm from `get(part)`."""
    return {"scale": get("weight"), "bias": get("bias")}


def convert_neox_family(hf: dict, cfg: GPTConfig) -> dict:
    """GPT-NeoX (`convert_neox_family` of the JAX package)."""
    n = cfg.n_layer

    def stacked(name):
        return torch.stack([hf[f"gpt_neox.layers.{i}.{name}"] for i in range(n)])

    def linear(name):
        return {"weight": stacked(f"{name}.weight"), "bias": stacked(f"{name}.bias")}

    return {
        "wte": {"weight": _pad_vocab(hf["gpt_neox.embed_in.weight"], cfg)},
        "ln_f": _layer_norm(lambda part: hf[f"gpt_neox.final_layer_norm.{part}"]),
        "lm_head": {"weight": _pad_vocab(hf["embed_out.weight"], cfg)},
        "blocks": {
            "norm_1": _layer_norm(lambda part: stacked(f"input_layernorm.{part}")),
            "norm_2": _layer_norm(lambda part: stacked(f"post_attention_layernorm.{part}")),
            "attn": {"qkv": linear("attention.query_key_value"),
                     "proj": linear("attention.dense")},
            "mlp": {"fc": linear("mlp.dense_h_to_4h"), "proj": linear("mlp.dense_4h_to_h")},
        },
    }


def convert_falcon_family(hf: dict, cfg: GPTConfig) -> dict:
    """Falcon (`convert_falcon_family` of the JAX package): a config with a
    shared attention norm (7b) reads `input_layernorm`, the others `ln_attn`
    and `ln_mlp` (the JAX converter tells them by a "7b" in the name, which
    picks the same layout for every Falcon of the registry)."""
    n = cfg.n_layer

    def stacked(name):
        return torch.stack([hf[f"transformer.h.{i}.{name}"] for i in range(n)])

    blocks = {
        "attn": {"qkv": {"weight": stacked("self_attention.query_key_value.weight")},
                 "proj": {"weight": stacked("self_attention.dense.weight")}},
        "mlp": {"fc": {"weight": stacked("mlp.dense_h_to_4h.weight")},
                "proj": {"weight": stacked("mlp.dense_4h_to_h.weight")}},
    }
    if cfg.shared_attention_norm:
        blocks["norm_1"] = _layer_norm(lambda part: stacked(f"input_layernorm.{part}"))
    else:
        blocks["norm_1"] = _layer_norm(lambda part: stacked(f"ln_attn.{part}"))
        blocks["norm_2"] = _layer_norm(lambda part: stacked(f"ln_mlp.{part}"))
    return {
        "wte": {"weight": _pad_vocab(hf["transformer.word_embeddings.weight"], cfg)},
        "ln_f": _layer_norm(lambda part: hf[f"transformer.ln_f.{part}"]),
        "lm_head": {"weight": _pad_vocab(hf["lm_head.weight"], cfg)},
        "blocks": blocks,
    }


def convert_phi_family(hf: dict, cfg: GPTConfig) -> dict:
    """Phi-1.5 / phi-2 (`convert_phi_family` of the JAX package)."""
    n = cfg.n_layer

    def layer(name, i):
        return hf[f"model.layers.{i}.{name}"]

    def stacked(name):
        return torch.stack([layer(name, i) for i in range(n)])

    def linear(name):
        return {"weight": stacked(f"{name}.weight"), "bias": stacked(f"{name}.bias")}

    def qkv(part):
        return torch.stack([
            interleave_qkv(*(layer(f"self_attn.{p}_proj.{part}", i) for p in "qkv"), cfg)
            for i in range(n)])

    return {
        "wte": {"weight": _pad_vocab(hf["model.embed_tokens.weight"], cfg)},
        "ln_f": _layer_norm(lambda part: hf[f"model.final_layernorm.{part}"]),
        "lm_head": {"weight": _pad_vocab(hf["lm_head.weight"], cfg),
                    "bias": _pad_vocab(hf["lm_head.bias"], cfg)},
        "blocks": {
            "norm_1": _layer_norm(lambda part: stacked(f"input_layernorm.{part}")),
            "attn": {"qkv": {"weight": qkv("weight"), "bias": qkv("bias")},
                     "proj": linear("self_attn.dense")},
            "mlp": {"fc": linear("mlp.fc1"), "proj": linear("mlp.fc2")},
        },
    }


def convert_hf_checkpoint(checkpoint_dir, model_name: str | None = None,
                          out_path=None, dtype: str | None = None) -> dict:
    """Convert an HF checkpoint directory to the parameter tree; with
    `out_path`, also write it as npz and `dualhyp_config.json` beside it."""
    checkpoint_dir = Path(checkpoint_dir)
    name = model_name or checkpoint_dir.name
    cfg = config_from_name(name)
    hf = load_hf_tensors(checkpoint_dir)
    if any("self_attn.dense" in k for k in hf):
        params = convert_phi_family(hf, cfg)
    elif any(k.startswith("model.layers.") for k in hf):
        params = convert_llama_family(hf, cfg)
    elif any(k.startswith("gpt_neox.") for k in hf):
        params = convert_neox_family(hf, cfg)
    elif any(k.startswith("transformer.h.") for k in hf):
        params = convert_falcon_family(hf, cfg)
    else:
        raise NotImplementedError(
            f"unrecognised checkpoint family; keys like {sorted(hf)[:3]}")
    del hf
    if dtype:
        params = _cast_tree(params, getattr(torch, dtype))
    if out_path is not None:
        from dualhyp_tpu_torch.ckpt.io import save_params

        out_path = Path(out_path)
        save_params(out_path, params)
        (out_path.parent / "dualhyp_config.json").write_text(cfg.to_json(), encoding="utf-8")
    return params


def _cast_tree(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--model_name", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--dtype", default=None)
    args = parser.parse_args()
    out = args.out or str(Path(args.checkpoint_dir) / "dualhyp_model.npz")
    convert_hf_checkpoint(args.checkpoint_dir, args.model_name, out, args.dtype)
    print(f"wrote {out}")
