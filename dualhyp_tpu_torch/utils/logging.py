"""Run logging: train.log + merged-by-step CSV.

A copy of `dualhyp_tpu/utils/logging.py`. Mirrors the reference's
observability (python logging to runs/<exp>/train.log
ref: finetune/ger.py:40-48, and the step-merged CSV logger
ref: ger/utils.py:501-527) without the Lightning dependency.
"""

from __future__ import annotations

import csv
import logging
import sys
from pathlib import Path
from typing import Dict, List


def setup_run_logger(out_dir, name: str = "dualhyp") -> logging.Logger:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s | %(message)s")
    for handler in (
        logging.FileHandler(out_dir / "train.log"),
        logging.StreamHandler(sys.stdout),
    ):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


class StepLogger:
    """Collects {step: metrics} rows; rows for the same step merge
    (== the reference's merge-by-step CSV override)."""

    def __init__(self, out_dir, filename: str = "metrics.csv"):
        self.path = Path(out_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.rows: Dict[int, dict] = {}

    def log(self, step: int, **metrics):
        self.rows.setdefault(step, {"step": step}).update(metrics)

    def save(self):
        if not self.rows:
            return
        merged: List[dict] = [self.rows[k] for k in sorted(self.rows)]
        keys = sorted({k for row in merged for k in row})
        with open(self.path, "w", newline="", encoding="utf-8") as fp:
            writer = csv.DictWriter(fp, fieldnames=keys)
            writer.writeheader()
            writer.writerows(merged)
