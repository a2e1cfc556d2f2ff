"""Metric logging: CSV/JSON artifacts + optional TensorBoard (the port's own
copy of ``tmar.utils.logging``, the same code).

Covers the reference's four observability mechanisms (SURVEY.md §5.5):
TensorBoard scalars, python logging, CSV/JSON histories, image artifacts.
TensorBoard is optional (torch's SummaryWriter if importable).
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Any, Dict, List, Optional


def setup_logging(log_file: Optional[str] = None, name: str = "tmar") -> logging.Logger:
    """File at DEBUG + console at INFO, the reference's split
    (benchmark_comparison_syndeeplesion.py:145-168)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    ch.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(ch)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
    return logger


class MetricLogger:
    def __init__(self, run_dir: str, tensorboard: bool = False):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.rows: List[Dict[str, Any]] = []
        self.tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                self.tb = None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        row = {"step": step}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            row[key] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(key, float(v), step)
        self.rows.append(row)

    def flush(self, name: str = "metrics"):
        if not self.rows:
            return
        fieldnames = sorted({k for r in self.rows for k in r})
        with open(os.path.join(self.run_dir, f"{name}.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(self.rows)
        with open(os.path.join(self.run_dir, f"{name}.json"), "w") as f:
            json.dump(self.rows, f)
        if self.tb is not None:
            self.tb.flush()
