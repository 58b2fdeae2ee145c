"""Named checkpoint config registry.

The reference ships a large python table of named checkpoint configs with
`from_name` / `from_json` / `from_checkpoint` constructors (ref:
ger/config.py:94-133 and the module-level `configs` list). Here the
hyperparameters of those public checkpoints live in `registry_data.json`
and this module provides the lookup logic.

Lookup also matches on HF repo name (`org/name` or bare `name`), mirroring
the reference's fallback search through `hf_config.name`
(ref: ger/config.py:94-109).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List

from dualhyp_tpu_torch.config import GPTConfig, normalize_config_fields

_DATA_PATH = Path(__file__).parent / "registry_data.json"


@lru_cache(maxsize=1)
def _registry() -> Dict[str, dict]:
    with open(_DATA_PATH, encoding="utf-8") as fp:
        return json.load(fp)


def available_configs() -> List[str]:
    return sorted(_registry())


def hf_repo_for(name: str) -> str:
    """HF hub repo id for a registry entry (for checkpoint download)."""
    entry = _registry().get(name)
    if entry is None:
        raise ValueError(f"{name!r} is not a known config name")
    return entry.get("hf_repo", "")


def config_from_name(name: str, **overrides) -> GPTConfig:
    """Build a GPTConfig for a named checkpoint, with field overrides.

    Overrides accept both our field names and the reference's legacy names
    (`r`, `alpha`, `to_query`, ... for LoRA; `condense_ratio`; `_norm_class`).
    """
    registry = _registry()
    resolved = name if name in registry else None
    if resolved is None:
        # fall back to matching the HF repo name ("org/name" or bare "name")
        for cfg_name, cfg in registry.items():
            repo = cfg.get("hf_repo", "")
            if name == repo or name == repo.split("/")[-1]:
                resolved = cfg_name
                break
    if resolved is None:
        raise ValueError(f"{name!r} is not a known config name")

    fields = {k: v for k, v in registry[resolved].items() if k != "hf_repo"}
    fields.update(normalize_config_fields(overrides))
    fields = normalize_config_fields(fields)
    fields["name"] = resolved
    return GPTConfig(**fields)


def config_from_checkpoint(checkpoint_dir, **overrides) -> GPTConfig:
    """Config from a checkpoint dir: its config JSON if present, else by
    directory name (ref: ger/config.py:126-133)."""
    checkpoint_dir = Path(checkpoint_dir)
    for fname in ("dualhyp_config.json", "lit_config.json"):
        if (checkpoint_dir / fname).is_file():
            with open(checkpoint_dir / fname, encoding="utf-8") as fp:
                raw = json.load(fp)
            raw.update(overrides)
            return GPTConfig(**normalize_config_fields(raw))
    return config_from_name(checkpoint_dir.name, **overrides)
