"""Metric meters, JSONL logging and training-curve plots.

Port of ``hocon/train/metrics.py``: per-term running means over an epoch
(``AverageMeters``), per-step ``metrics.jsonl`` and per-epoch
``epochs.json`` under the run directory with the reference's layout
(``MetricWriter``), matplotlib curves under ``plots/`` where matplotlib is
installed, and steps per second past a warm-up (``StepTimer``).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np


class AverageMeters:
    def __init__(self):
        self._sum = defaultdict(float)
        self._count = defaultdict(int)

    def update(self, values: dict, n: int = 1):
        for k, v in values.items():
            v = float(np.asarray(v))
            if np.isfinite(v):
                self._sum[k] += v * n
                self._count[k] += n

    def averages(self) -> dict:
        return {k: self._sum[k] / max(self._count[k], 1) for k in self._sum}

    def reset(self):
        self._sum.clear()
        self._count.clear()


class MetricWriter:
    """Per-step JSONL, per-epoch summaries and curve plots of one run."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._epochs_path = os.path.join(run_dir, "epochs.json")
        self._history = []
        if os.path.exists(self._epochs_path):
            with open(self._epochs_path) as f:
                self._history = json.load(f)

    def log_step(self, step: int, values: dict):
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(np.asarray(v)) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_epoch(self, epoch: int, split: str, values: dict):
        rec = {"epoch": epoch, "split": split}
        rec.update({k: float(np.asarray(v)) for k, v in values.items()})
        self._history.append(rec)
        with open(self._epochs_path, "w") as f:
            json.dump(self._history, f, indent=1)

    def plot_curves(self, keys: Optional[list] = None):
        """Train / val curves per key under ``<run_dir>/plots/``; nothing
        where matplotlib is not installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        if not self._history:
            return
        all_keys = keys or sorted(
            {k for r in self._history for k in r if k not in ("epoch", "split")}
        )
        plot_dir = os.path.join(self.run_dir, "plots")
        os.makedirs(plot_dir, exist_ok=True)
        for key in all_keys:
            fig, ax = plt.subplots(figsize=(5, 3))
            for split in sorted({r["split"] for r in self._history}):
                pts = [
                    (r["epoch"], r[key])
                    for r in self._history
                    if r["split"] == split and key in r
                ]
                if pts:
                    xs, ys = zip(*pts)
                    ax.plot(xs, ys, marker="o", label=split)
            ax.set_xlabel("epoch")
            ax.set_ylabel(key)
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(plot_dir, f"{key}.png"), dpi=80)
            plt.close(fig)

    def close(self):
        self._jsonl.close()


class StepTimer:
    """Steps per second, skipping the first ``warmup`` steps."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._t0 = None  # start of the post-warm-up window
        self._start = time.perf_counter()  # for epochs no longer than the warm-up
        self._steps = 0

    def tick(self):
        self._steps += 1
        if self._steps == self.warmup:
            self._t0 = time.perf_counter()

    def rate(self) -> float:
        if self._t0 is not None and self._steps > self.warmup:
            return (self._steps - self.warmup) / (time.perf_counter() - self._t0)
        # Epochs no longer than the warm-up report the rate including it.
        if self._steps == 0:
            return float("nan")
        return self._steps / (time.perf_counter() - self._start)
