# Copied from protein_redesign_tpu/utils/logging.py so the port imports nothing of
# the JAX package: MetricsLogger, with its values read as plain floats (the original
# reads them through parallel.mesh.host_scalar), and maybe_profile on torch.profiler
# where the original's runs jax.profiler.
"""Metrics logging: JSONL + CSV metric streams under the save dir."""

from __future__ import annotations

import csv
import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Union


class MetricsLogger:
    """Append-only JSONL + CSV metrics under <save_dir>/metrics.*

    ``enabled=False`` turns every log() into a no-op: on multi-host
    runs only process 0 may write (every host computes identical global
    metrics, and hosts share the save dir on clustered filesystems —
    unconditional appends interleave duplicate rows; the reference's
    Lightning logger is rank-zero-only the same way)."""

    def __init__(self, save_dir: Union[str, Path], enabled: bool = True):
        self.enabled = enabled
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.dir / "metrics.jsonl"
        self.csv_path = self.dir / "metrics.csv"
        self._csv_fields: Optional[list] = None
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        row = {
            "step": int(step),
            "time": round(time.time() - self._t0, 3),
            **{k: _scalar(v) for k, v in metrics.items()},
        }
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._csv_fields is None:
            self._csv_fields = list(row.keys())
            if not self.csv_path.exists():
                with open(self.csv_path, "w", newline="") as f:
                    csv.DictWriter(f, self._csv_fields).writeheader()
        with open(self.csv_path, "a", newline="") as f:
            csv.DictWriter(
                f, self._csv_fields, extrasaction="ignore"
            ).writerow(row)


def _scalar(v: Any) -> Any:
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


@contextmanager
def maybe_profile(
    save_dir: Union[str, Path], enabled: bool, device: Any = "cpu"
) -> Iterator[None]:
    """Capture a torch.profiler trace into <save_dir>/profile when enabled:
    the host's operators, and the card's kernels where ``device`` is a GPU
    (written on exit, in TensorBoard's trace format)."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace_dir = str(Path(save_dir) / "profile")
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
