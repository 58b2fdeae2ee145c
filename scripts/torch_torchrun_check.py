#!/usr/bin/env python3
"""`cli.finetune_ger` launched by torchrun on the card: one rank, NCCL.

    CUDA_VISIBLE_DEVICES=0 python3 scripts/torch_torchrun_check.py [--nproc 1]

Writes a tiny LLaMA checkpoint directory (config JSON, random npz weights,
a word-level `tokenizer.json`) and a DualHyp corpus into a temporary
directory, then runs

    torchrun --standalone --nproc_per_node N -m dualhyp_tpu_torch.cli.finetune_ger ...

there (one epoch, 2 steps) and prints one JSON line: the exit code, the
mesh and backend the CLI logged, its step losses, the files it wrote, and
the card's name and power limit. A torchrun job joins its process group
even at one rank (`cli.common.wants_mesh`), so this runs the mesh path
under NCCL. Needs the `tokenizers` package (the CLI's tokenizer).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def write_checkpoint(root: Path, seed: int) -> Path:
    """A tiny LLaMA (2 layers, width 128) the CLI loads, its tokenizer over
    the synthetic corpus's words."""
    import torch
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit

    from dualhyp_tpu_torch.ckpt.convert import tree_from_model
    from dualhyp_tpu_torch.ckpt.io import save_params
    from dualhyp_tpu_torch.config import GPTConfig
    from dualhyp_tpu_torch.data import prompts, synthetic
    from dualhyp_tpu_torch.models.gpt import GPT

    ckpt = root / "tiny-llama-test"
    ckpt.mkdir()
    words = sorted(set(synthetic.word_vocabulary())
                   | set(" ".join(prompts.DualHyp_PROMPTS.values()).split()))
    vocab = {"<unk>": 0, "</s>": 1, "<s>": 2}
    for w in words:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.add_special_tokens(["</s>", "<s>"])
    tok.save(str(ckpt / "tokenizer.json"))
    (ckpt / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "</s>",
         "bos_token": "<s>"}))
    cfg = GPTConfig(name="tiny-llama-test", block_size=640, vocab_size=len(vocab),
                    padding_multiple=64, n_layer=2, n_head=4, n_query_groups=2, n_embd=128,
                    rotary_percentage=1.0, parallel_residual=False, bias=False,
                    norm_class="RMSNorm", mlp_class="LLaMAMLP", intermediate_size=256)
    model = GPT(cfg, device="cpu", dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(seed))
    save_params(ckpt / "dualhyp_model.npz", tree_from_model(model))
    (ckpt / "dualhyp_config.json").write_text(cfg.to_json())
    for split, n, s in (("train", 8, seed), ("val", 4, seed + 1)):
        synthetic.write_json(root / f"{split}.json",
                             synthetic.make_records(n_uids=n, n_hyps=5, seed=s))
    return ckpt


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nproc", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = write_checkpoint(root, args.seed)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={args.nproc}", "-m", "dualhyp_tpu_torch.cli.finetune_ger",
               "--train_path", str(root / "train.json"), "--val_path", str(root / "val.json"),
               "--llm_checkpoint", str(ckpt), "--dual_hypotheses", "--prompts_format",
               "DualHyp", "--batch_size", "4", "--micro_batch_size", "4", "--num_epochs", "1",
               "--log_interval", "1", "--exp_name", "torchrun", "--save_adapter_only"]
        env = dict(os.environ, PYTHONPATH=str(REPO))
        run = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                             timeout=600)
        log = run.stdout + run.stderr
        out = root / "runs" / "torchrun"
        result = {
            "command": "torchrun --standalone --nproc_per_node "
                       f"{args.nproc} -m dualhyp_tpu_torch.cli.finetune_ger ...",
            "rc": run.returncode,
            "mesh": re.findall(r"mesh: (.*)", log),
            "losses": [float(x) for x in re.findall(r"step \d+: loss ([0-9.]+)", log)],
            "written": sorted(p.name for p in out.iterdir()) if out.is_dir() else [],
            "log_tail": log[-1500:] if run.returncode else "",
        }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    result["card"] = smi.stdout.strip()
    print(json.dumps(result), flush=True)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
