"""Structured metrics logging.

Counterpart of ``canonicalvoting_tpu/utils/metrics_log.py``, writing the
same files: each row streams to ``<name>.csv`` and ``<name>.jsonl`` in
``workdir`` (the reference logs loss strings only, upstream
``train_joint.py:461-473``), and per-class AP/AR tables go out in the
quantities the reference prints.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, workdir: str, name: str = "metrics"):
        os.makedirs(workdir, exist_ok=True)
        self.csv_path = os.path.join(workdir, f"{name}.csv")
        self.jsonl_path = os.path.join(workdir, f"{name}.jsonl")
        self._fieldnames = None

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        row = {"step": step, "time": round(time.time(), 3)}
        for k, v in metrics.items():
            key = f"{prefix}{k}" if prefix else k
            try:
                row[key] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        write_header = (
            self._fieldnames is None and not os.path.exists(self.csv_path)
        )
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames,
                               extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow(row)

    def log_map_table(self, step: int, ret_dict: Dict, thresh: float):
        """Per-class AP/AR in the reference's quantities
        (train_joint.py:463-473)."""
        self.log(step, ret_dict, prefix=f"iou{thresh}/")
