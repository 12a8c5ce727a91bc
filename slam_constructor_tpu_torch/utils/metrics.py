"""Per-step metrics with JSONL export (port of
``slam_constructor_tpu.utils.metrics``)."""

from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np


class MetricsLogger:
    """Append-only per-step metric recorder. A value that converts to a
    float (a number, a 0-d tensor) is stored as one; anything else as it
    is."""

    def __init__(self):
        self.rows: list[dict] = []
        self._t_start = time.time()

    def log(self, step: int, **values) -> None:
        row = {"step": int(step), "t": time.time() - self._t_start}
        for k, v in values.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self.rows.append(row)

    def summary(self) -> dict:
        """mean, min, max and last of each float metric ("t" excepted)."""
        cols: dict[str, list] = defaultdict(list)
        for row in self.rows:
            for k, v in row.items():
                if isinstance(v, float) and k != "t":
                    cols[k].append(v)
        out = {}
        for k, vs in cols.items():
            a = np.asarray(vs)
            out[k] = {"mean": float(a.mean()), "min": float(a.min()), "max": float(a.max()),
                      "last": float(a[-1])}
        return out

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")

    @staticmethod
    def load_jsonl(path: str) -> "MetricsLogger":
        m = MetricsLogger()
        with open(path) as f:
            m.rows = [json.loads(line) for line in f if line.strip()]
        return m
