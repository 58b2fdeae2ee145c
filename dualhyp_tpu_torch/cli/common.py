"""Shared CLI plumbing (the parts of `dualhyp_tpu/cli/common.py` that the
finetuning and correction-decoding entry points need): the model, data and
mesh flags, the model config (RelPrompt's too), the checkpoint checks, the
tokenizer, the dataset class and the weights.

The mesh flags (`add_mesh_args`: --dp, --fsdp, --tensor, --expert, --seq,
the JAX package's, with its defaults) run an entry point as one rank of a
torchrun job, one card a rank (`mesh_from_args`):

  torchrun --nproc_per_node N -m dualhyp_tpu_torch.cli.finetune_ger --tensor 2 ...
"""

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


def add_mesh_args(parser: argparse.ArgumentParser):
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel mesh extent (default: all devices)")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="parameter-sharding mesh extent (ZeRO-3 equivalent)")
    parser.add_argument("--tensor", type=int, default=1,
                        help="tensor-parallel mesh extent (for >7B configs)")
    parser.add_argument("--expert", type=int, default=1,
                        help="expert-parallel mesh extent (MoE configs: "
                             "experts shard over this axis)")
    parser.add_argument("--seq", type=int, default=1,
                        help="sequence-parallel mesh extent (activations "
                             "shard over tokens; long-context headroom)")


def wants_mesh(args) -> bool:
    """Whether the flags or the job ask for a mesh: an axis above 1, or a
    torchrun job (`RANK` set), which joins its process group even at one
    rank."""
    import os

    return (args.fsdp > 1 or args.tensor > 1 or args.expert > 1 or args.seq > 1
            or (args.dp or 0) > 1 or "RANK" in os.environ)


def mesh_from_args(args, dp=None):
    """(the mesh of the flags, this rank's device): joins the job's process
    group (`parallel.init_distributed`: the card `cuda:LOCAL_RANK` and NCCL,
    or --device cpu and gloo) and lays its ranks out (`parallel.make_mesh`).
    dp: the data extent (None: --dp, or the world over the model axes)."""
    import os

    import torch.distributed as dist

    from dualhyp_tpu_torch.parallel import init_distributed, make_mesh

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    model_axes = args.fsdp * args.tensor * args.expert * args.seq
    data = dp if dp is not None else args.dp if args.dp is not None else world // model_axes
    if data * model_axes != world:
        # a usage error, before any process group: as the parser reports one
        raise SystemExit(f"the mesh {data}x{args.fsdp}x{args.tensor}x{args.expert}x"
                         f"{args.seq} needs {data * model_axes} ranks and the job has "
                         f"{world}: launch it with torchrun --nproc_per_node "
                         f"{data * model_axes}")
    device = init_distributed(device=args.device)
    mesh = make_mesh(data=data, fsdp=args.fsdp, tensor=args.tensor, expert=args.expert,
                     seq=args.seq)
    return mesh, device


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
               finetuned=None, mesh=None) -> GPT:
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
    its base weights with `n_extra_tokens=0` and then extends them. mesh:
    the rank's piece of the model (`GPT(mesh=)`), its random leaves those
    of a one-rank init."""
    checkpoint_dir = Path(checkpoint_dir)
    model = GPT(cfg, device=device, dtype=dtype, mesh=mesh)
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
