"""Tokenizer wrapper over the HF `tokenizers` backend.

Same behavior as the reference wrapper (ref: ger/tokenizer.py:8-113):
  * loads `tokenizer.json` from a checkpoint dir
  * BOS/EOS ids resolved from tokenizer_config.json / generation_config.json
  * the BOS-usage heuristic: add_bos_token / add_prefix_space flags, or the
    LlamaTokenizer-with-unset-add_bos_token case (ref: ger/tokenizer.py:65-74)
  * `add_special_tokens` for the RelPrompt mask vocab

Duck-type compatible with `transformers.AutoTokenizer` for the dataset layer
(the reference trainers use AutoTokenizer directly, ref: finetune/ger.py:88).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional


class Tokenizer:
    def __init__(self, checkpoint_dir) -> None:
        checkpoint_dir = Path(checkpoint_dir)
        vocab_path = checkpoint_dir / "tokenizer.json"
        if not vocab_path.is_file():
            raise FileNotFoundError(f"no tokenizer.json under {checkpoint_dir}")
        from tokenizers import Tokenizer as HFTokenizer

        self.processor = HFTokenizer.from_file(str(vocab_path))
        self.use_bos = self._bos_token_used(checkpoint_dir)
        self.bos_id: Optional[int] = None
        self.eos_id: Optional[int] = None
        self._eos_token: Optional[str] = None

        cfg_path = checkpoint_dir / "tokenizer_config.json"
        if cfg_path.is_file():
            with open(cfg_path, encoding="utf-8") as fp:
                cfg = json.load(fp)
            bos_token = _token_str(cfg.get("bos_token"))
            eos_token = _token_str(cfg.get("eos_token"))
            if bos_token is not None:
                self.bos_id = self.token_to_id(bos_token)
            if eos_token is not None:
                self.eos_id = self.token_to_id(eos_token)
                self._eos_token = eos_token
        gen_path = checkpoint_dir / "generation_config.json"
        if gen_path.is_file():
            with open(gen_path, encoding="utf-8") as fp:
                cfg = json.load(fp)
            if self.bos_id is None:
                self.bos_id = cfg.get("bos_token_id")
            if self.eos_id is None:
                self.eos_id = cfg.get("eos_token_id")

    @staticmethod
    def _bos_token_used(checkpoint_dir: Path) -> bool:
        cfg_path = checkpoint_dir / "tokenizer_config.json"
        if not cfg_path.is_file():
            return False
        with open(cfg_path, encoding="utf-8") as fp:
            cfg = json.load(fp)
        if any(cfg.get(flag, False) for flag in ("add_bos_token", "add_prefix_space")):
            return True
        return (
            cfg.get("add_bos_token") is None
            and cfg.get("tokenizer_class") == "LlamaTokenizer"
        )

    # ---- API ----
    @property
    def vocab_size(self) -> int:
        return self.processor.get_vocab_size(with_added_tokens=False)

    @property
    def eos_token(self) -> str:
        if self._eos_token is not None:
            return self._eos_token
        if self.eos_id is not None:
            return self.processor.id_to_token(self.eos_id)
        return "</s>"

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.eos_id

    def token_to_id(self, token: str) -> int:
        tid = self.processor.token_to_id(token)
        if tid is None:
            raise ValueError(f"token {token!r} not found in the vocabulary")
        return tid

    def encode(
        self,
        text: str,
        bos: Optional[bool] = None,
        eos: bool = False,
        max_length: int = -1,
    ) -> List[int]:
        ids = self.processor.encode(text).ids
        if bos or (bos is None and self.use_bos):
            if self.bos_id is None:
                raise ValueError("tokenizer has no BOS token defined")
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        if max_length > 0:
            ids = ids[:max_length]
        return ids

    def decode(self, ids) -> str:
        ids = list(int(i) for i in ids)
        return self.processor.decode(ids)

    def add_special_tokens(self, tokens: List[str]) -> None:
        self.processor.add_special_tokens(tokens)


def _token_str(value):
    """tokenizer_config bos/eos entries are strings or {'content': ...}."""
    if isinstance(value, dict):
        return value.get("content")
    return value
