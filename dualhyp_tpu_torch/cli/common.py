"""Shared CLI plumbing (the parts of `dualhyp_tpu/cli/common.py` that the
correction-decoding entry point needs): the model and data flags, the model
config, the tokenizer, the dataset class and the weights."""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from dualhyp_tpu_torch.ckpt.convert import load_tree
from dualhyp_tpu_torch.ckpt.io import load_params
from dualhyp_tpu_torch.models.gpt import GPT


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
                        help="PEFT family of the checkpoint (adapters are not "
                             "ported yet)")


def add_data_args(parser: argparse.ArgumentParser):
    parser.add_argument("--nhyps_key", type=str, default="nhyps_asr")
    parser.add_argument("--dual_hypotheses", action="store_true")
    parser.add_argument("--max_nhyps", type=int, default=None)
    parser.add_argument("--prompts_format", type=str, default="GER")
    parser.add_argument("--apply_chat_template", action="store_true")
    parser.add_argument("--language", type=str, default=None)


def model_config_from_args(args):
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
    return config_from_checkpoint(Path(args.llm_checkpoint), **overrides)


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
            raise NotImplementedError("RelPrompt is not ported yet")
        return hypotheses.DualHypothesesDataset
    return hypotheses.HypothesesDataset


def load_model(checkpoint_dir, cfg, *, device, seed: int, dtype=torch.bfloat16,
               finetuned=None) -> GPT:
    """The model with converted base weights when the checkpoint directory
    has them (`dualhyp_model.npz`), else random weights from `seed` with a
    warning; then the finetuned leaves (`finetuned`, an npz path) over them.
    Leaves a checkpoint lacks keep their initial values, as the reference's
    strict=False load does."""
    checkpoint_dir = Path(checkpoint_dir)
    model = GPT(cfg, device=device, dtype=dtype)
    generator = torch.Generator(device=model.device)
    generator.manual_seed(seed)
    model.init_weights(generator)
    npz = checkpoint_dir / "dualhyp_model.npz"
    if npz.is_file():
        load_tree(model, load_params(npz), strict=False)
    elif list(checkpoint_dir.glob("*.safetensors")):
        raise NotImplementedError(
            f"{checkpoint_dir} holds HF safetensors: their conversion is not "
            "ported yet; convert them to dualhyp_model.npz with "
            "`python -m dualhyp_tpu.cli.download` first")
    else:
        print(f"WARNING: no weights found under {checkpoint_dir}; random init "
              f"from seed {seed}")
    if finetuned is not None:
        load_tree(model, load_params(finetuned), strict=False)
    return model
