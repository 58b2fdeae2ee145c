"""Shared CLI plumbing (the parts of `dualhyp_tpu/cli/common.py` that the
finetuning and correction-decoding entry points need): the model and data
flags, the model config (RelPrompt's too), the checkpoint checks, the
tokenizer, the dataset class and the weights."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from dualhyp_tpu_torch.ckpt.convert import load_tree
from dualhyp_tpu_torch.ckpt.convert_hf import convert_hf_checkpoint
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.models.gpt import GPT
from dualhyp_tpu_torch.models.relprompt import extend_embeddings


def add_model_args(parser: argparse.ArgumentParser):
    parser.add_argument("--llm_checkpoint", type=str,
                        default="checkpoints/TinyLlama/TinyLlama-1.1B-Chat-v1.0")
    parser.add_argument("--lora_r", type=int, default=16)
    parser.add_argument("--lora_alpha", type=int, default=16)
    parser.add_argument("--lora_dropout", type=float, default=0.05)
    parser.add_argument("--lora_query", type=bool, default=True)
    parser.add_argument("--lora_key", type=bool, default=True)
    parser.add_argument("--lora_value", type=bool, default=True)
    parser.add_argument("--lora_projection", type=bool, default=True)
    parser.add_argument("--lora_mlp", type=bool, default=False)
    parser.add_argument("--lora_head", type=bool, default=False)
    parser.add_argument("--mode", type=str, default="lora",
                        choices=["lora", "adapter", "adapter_v2", "full"],
                        help="PEFT family of the checkpoint: adapter and "
                             "adapter_v2 drop LoRA for LLaMA-Adapter v1 / v2, "
                             "full trains every weight")


def add_data_args(parser: argparse.ArgumentParser):
    parser.add_argument("--nhyps_key", type=str, default="nhyps_asr")
    parser.add_argument("--dual_hypotheses", action="store_true")
    parser.add_argument("--max_nhyps", type=int, default=None)
    parser.add_argument("--prompts_format", type=str, default="GER")
    parser.add_argument("--apply_chat_template", action="store_true")
    parser.add_argument("--language", type=str, default=None)
    # RelPrompt's mask dataset: whether the recorded corruption counts when
    # the ground-truth masks are built (the text-only GER and DualHyp
    # datasets load no waveforms or mouth ROIs and ignore them)
    parser.add_argument("--audio_corruption_disabled", action="store_true")
    parser.add_argument("--visual_corruption_disabled", action="store_true")


def model_config_from_args(args, relprompt: bool = False):
    """The checkpoint's config with the flags' LoRA (or adapter) settings;
    relprompt: the two classifiers and the three mask-token rows too."""
    from dualhyp_tpu_torch.registry import config_from_checkpoint

    overrides = dict(
        lora_r=args.lora_r,
        lora_alpha=args.lora_alpha,
        lora_dropout=args.lora_dropout,
        lora_query=args.lora_query,
        lora_key=args.lora_key,
        lora_value=args.lora_value,
        lora_projection=args.lora_projection,
        lora_mlp=args.lora_mlp,
        lora_head=args.lora_head,
    )
    if args.mode in ("adapter", "adapter_v2"):
        overrides.update(lora_r=0, use_adapter=True,
                         use_adapter_v2=(args.mode == "adapter_v2"))
    elif args.mode == "full":
        overrides.update(lora_r=0)
    if relprompt:
        overrides.update(use_relprompt=True, n_extra_tokens=3)
    return config_from_checkpoint(Path(args.llm_checkpoint), **overrides)


def max_input_length_from_checkpoint(checkpoint_dir, default: int = 1024) -> int:
    """(ref: finetune/ger.py:421-425)"""
    cfg_path = Path(checkpoint_dir) / "tokenizer_config.json"
    if cfg_path.is_file():
        with open(cfg_path, encoding="utf-8") as fp:
            tok_cfg = json.load(fp)
        value = tok_cfg.get("model_max_length")
        if isinstance(value, int) and value < 10**9:
            return value
    return default


def check_valid_checkpoint_dir(checkpoint_dir) -> None:
    """Actionable error listing what is missing (== ger/utils.py:239-270)."""
    checkpoint_dir = Path(checkpoint_dir)
    problems = []
    if not checkpoint_dir.is_dir():
        problems.append(f"checkpoint dir {checkpoint_dir} does not exist")
    else:
        if not ((checkpoint_dir / "dualhyp_model.npz").is_file()
                or list(checkpoint_dir.glob("*.safetensors"))):
            problems.append("no weights: expected dualhyp_model.npz (converted) or HF "
                            "*.safetensors files")
        if not ((checkpoint_dir / "tokenizer.json").is_file()
                or (checkpoint_dir / "tokenizer_config.json").is_file()):
            problems.append("no tokenizer files (tokenizer.json / tokenizer_config.json)")
    if problems:
        raise FileNotFoundError(
            f"invalid checkpoint dir {str(checkpoint_dir)!r}:\n  - "
            + "\n  - ".join(problems)
            + "\n\nDownload + convert one with:\n  python -m dualhyp_tpu.cli."
            "download --repo_id <org>/<name>")


def load_tokenizer(checkpoint_dir):
    """HF AutoTokenizer when `transformers` is installed and reads the
    directory, else this package's `tokenizers`-backed wrapper."""
    try:
        from transformers import AutoTokenizer
    except ImportError:
        AutoTokenizer = None
    if AutoTokenizer is not None:
        try:
            tok = AutoTokenizer.from_pretrained(
                checkpoint_dir, use_fast=True, padding_side="left")
        except (OSError, ValueError):
            tok = None
        if tok is not None:
            if tok.pad_token is None:
                tok.pad_token = tok.eos_token
            if "phi-" in str(checkpoint_dir).lower():
                # phi checkpoints ship the wrong eos in tokenizer_config
                # (ref: finetune/ger.py:119-120)
                tok.eos_token = "<|endoftext|>"
            return tok
    from dualhyp_tpu_torch.data.tokenizer import Tokenizer

    return Tokenizer(checkpoint_dir)


def dataset_class_for(args):
    from dualhyp_tpu_torch.data import hypotheses

    if args.dual_hypotheses:
        if args.prompts_format == "RelPrompt":
            return hypotheses.DualHypothesesMaskDataset
        return hypotheses.DualHypothesesDataset
    return hypotheses.HypothesesDataset


def load_model(checkpoint_dir, cfg, *, device, seed: int, dtype=torch.bfloat16,
               finetuned=None) -> GPT:
    """The model with the checkpoint directory's base weights: converted
    ones (`dualhyp_model.npz`) if it has them, else HF `*.safetensors`
    shards converted on the fly (`ckpt.convert_hf`: the LLaMA, GPT-NeoX,
    Falcon and Phi families), as
    `dualhyp_tpu/cli/common.py:load_base_params` does; else random weights
    from `seed` with a warning. Then the finetuned leaves (`finetuned`, an
    npz path) over them. Leaves a checkpoint lacks keep their initial
    values, as the reference's strict=False load does. A RelPrompt config
    (`n_extra_tokens`) takes base weights without the extra rows and
    appends them (`relprompt.extend_embeddings`), as the JAX package loads
    its base weights with `n_extra_tokens=0` and then extends them."""
    checkpoint_dir = Path(checkpoint_dir)
    model = GPT(cfg, device=device, dtype=dtype)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(seed)
    model.init_weights(generator)
    npz = checkpoint_dir / "dualhyp_model.npz"
    if npz.is_file():
        tree = load_params(npz)
    elif list(checkpoint_dir.glob("*.safetensors")):
        tree = convert_hf_checkpoint(checkpoint_dir, cfg.name)
    else:
        tree = None
        print(f"WARNING: no weights found under {checkpoint_dir}; random init "
              f"from seed {seed}")
    if tree is not None:
        if cfg.n_extra_tokens and len(tree["wte"]["weight"]) == cfg.padded_vocab_size:
            tree = extend_embeddings(tree, generator, cfg.n_extra_tokens)
        load_tree(model, tree, strict=False)
        del tree
    if finetuned is not None:
        load_tree(model, load_params(finetuned), strict=False)
    return model
