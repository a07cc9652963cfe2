"""Torch-native train checkpoints with top-k retention by val_loss (port of
``protein_redesign_tpu/utils/checkpoint.py``, which keeps them with Orbax).

A manager directory holds one subdirectory per saved step, ``<step>/``, with
``config.json`` (the ModelConfig fields), ``params.pt`` and ``ema.pt``
(state_dicts under the reference names), ``optimizer.pt`` (Adam's state) and
``state.json`` (step, ema_updates, val_loss). Retention is the JAX
manager's: the ``top_k`` lowest val_loss, every step saved without a
val_loss, and the latest step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, List, Optional, Tuple, Union

import torch

from protein_redesign_tpu.config import ModelConfig

from ..parallel.train_step import TrainState

STATE_FILE = "state.json"


class CheckpointManager:
    def __init__(self, directory: Union[str, Path], top_k: int = 3):
        self.directory = Path(directory)
        self.top_k = top_k
        self.directory.mkdir(parents=True, exist_ok=True)

    def steps(self) -> List[int]:
        return checkpoint_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, val_loss: Optional[float] = None) -> Path:
        """Write the state at its step (replacing a save of the same step)
        and apply the retention rule."""
        final = self.directory / str(state.step)
        tmp = Path(tempfile.mkdtemp(dir=self.directory, prefix=".tmp-"))
        (tmp / "config.json").write_text(json.dumps(dataclasses.asdict(state.net.cfg)))
        torch.save(_cpu(state.net.state_dict()), tmp / "params.pt")
        torch.save(_cpu(state.ema.state_dict()), tmp / "ema.pt")
        torch.save(state.optimizer.state_dict(), tmp / "optimizer.pt")
        (tmp / STATE_FILE).write_text(json.dumps({
            "step": state.step, "ema_updates": state.ema_updates,
            "val_loss": None if val_loss is None else float(val_loss),
        }))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._retain()
        return final

    def _retain(self) -> None:
        steps = self.steps()
        losses = {s: read_state(self.directory / str(s))["val_loss"] for s in steps}
        scored = sorted((loss, s) for s, loss in losses.items() if loss is not None)
        keep = {s for _, s in scored[: self.top_k]}
        keep |= {s for s, loss in losses.items() if loss is None}
        keep.add(steps[-1])
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.directory / str(s))


def _cpu(state_dict) -> dict:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def checkpoint_steps(directory: Union[str, Path]) -> List[int]:
    directory = Path(directory)
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).exists())


def read_state(step_dir: Union[str, Path]) -> dict:
    return json.loads((Path(step_dir) / STATE_FILE).read_text())


def step_dir(directory: Union[str, Path], prefer: str = "latest") -> Path:
    """The step directory to load: ``directory`` itself when it is one, else
    its latest step ("latest", resume) or its lowest val_loss ("best",
    inference; the latest when no step has a val_loss)."""
    if prefer not in ("latest", "best"):
        raise ValueError(f"prefer must be 'latest' or 'best', got {prefer!r}")
    directory = Path(directory)
    if (directory / STATE_FILE).exists():
        return directory
    steps = checkpoint_steps(directory) if directory.is_dir() else []
    if not steps:
        raise FileNotFoundError(f"No checkpoints under {directory}")
    chosen = steps[-1]
    if prefer == "best":
        scored = [(read_state(directory / str(s))["val_loss"], s) for s in steps]
        scored = [(loss, s) for loss, s in scored if loss is not None]
        if scored:
            chosen = min(scored)[1]
    return directory / str(chosen)


def read_config(path: Union[str, Path], **overrides: Any) -> ModelConfig:
    from .weights import config_from_dict

    cfg_dict = json.loads((Path(path) / "config.json").read_text())
    cfg_dict.update(overrides)
    return config_from_dict(cfg_dict)


def load_train_state(path: Union[str, Path], state: TrainState) -> None:
    """Restore params, EMA, optimizer state and counters from a step
    directory into ``state`` (built from the same config)."""
    path = Path(path)
    device = next(state.net.parameters()).device
    state.net.load_state_dict(torch.load(path / "params.pt", map_location=device,
                                         weights_only=True))
    state.ema.load_state_dict(torch.load(path / "ema.pt", map_location=device,
                                         weights_only=True))
    state.optimizer.load_state_dict(torch.load(path / "optimizer.pt", map_location=device,
                                               weights_only=True))
    meta = read_state(path)
    state.step, state.ema_updates = int(meta["step"]), int(meta["ema_updates"])


def load_ema_weights(path: Union[str, Path], **overrides: Any) -> Tuple[dict, ModelConfig]:
    """(EMA state_dict, config) of the best step of a train checkpoint
    directory, as the JAX generate CLI samples from (`cli/generate.py:175-184`)."""
    chosen = step_dir(path, prefer="best")
    sd = torch.load(chosen / "ema.pt", map_location="cpu", weights_only=True)
    return sd, read_config(chosen, **overrides)
