"""HF checkpoint directory -> the JAX package's parameter tree, LLaMA family.

Counterpart of the LLaMA-family half of `dualhyp_tpu/ckpt/convert_hf.py`,
with the same arithmetic: the separate HF q/k/v projections interleave into
one fused per-group QKV weight (per query group, q_per_kv query-head row
blocks, then one K and one V block), the vocabulary rows pad to
`padded_vocab_size`, and per-layer tensors stack on a leading (n_layer, ...)
axis. TinyLlama, Llama-2/3 and Mistral convert; so do Mixtral's
`block_sparse_moe` router and experts (w1 -> fc_1, w3 -> fc_2, w2 -> proj,
stacked (n_layer, n_expert, out, in)).

Shards are read with `ckpt.io.load_safetensors` (the card's machine has no
`safetensors` package); the tree's leaves are CPU torch tensors in their
stored dtype, cast with torch when a dtype is asked for. `load_tree` and
`ckpt.io.save_params` take such a tree as they take the JAX package's.

The NeoX, Falcon and Phi families are not ported (ROADMAP §1, model-family
breadth): they raise, as the port's `models.gpt.check_supported` refuses
those configs anyway.

    python -m dualhyp_tpu_torch.ckpt.convert_hf --checkpoint_dir <hf dir> \
        [--model_name tiny-llama-1.1b-chat] [--out <npz>] [--dtype bfloat16]

writes `dualhyp_model.npz` (or --out) and `dualhyp_config.json` beside it.
"""

from __future__ import annotations

from pathlib import Path

import torch

from dualhyp_tpu_torch.config import GPTConfig
from dualhyp_tpu_torch.registry import config_from_name

_NOT_PORTED = ("the {} checkpoint family is not ported yet (ROADMAP §1, "
               "model-family breadth); the port converts LLaMA-family checkpoints")


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


def convert_hf_checkpoint(checkpoint_dir, model_name: str | None = None,
                          out_path=None, dtype: str | None = None) -> dict:
    """Convert an HF checkpoint directory to the parameter tree; with
    `out_path`, also write it as npz and `dualhyp_config.json` beside it."""
    checkpoint_dir = Path(checkpoint_dir)
    name = model_name or checkpoint_dir.name
    cfg = config_from_name(name)
    hf = load_hf_tensors(checkpoint_dir)
    if any("self_attn.dense" in k for k in hf):
        raise NotImplementedError(_NOT_PORTED.format("Phi"))
    if any(k.startswith("model.layers.") for k in hf):
        params = convert_llama_family(hf, cfg)
    elif any(k.startswith("gpt_neox.") for k in hf):
        raise NotImplementedError(_NOT_PORTED.format("GPT-NeoX"))
    elif any(k.startswith("transformer.h.") for k in hf):
        raise NotImplementedError(_NOT_PORTED.format("Falcon"))
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
