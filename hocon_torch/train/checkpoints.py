"""Checkpoint save / resume with ``torch.save``.

Port of ``hocon/train/checkpoints.py``, which keeps Orbax checkpoints of
the train state. One directory per step under ``directory``
(``<directory>/<step>/state.pt``) holds:

- ``model``: the model's ``state_dict`` (parameters and batch-norm
  buffers);
- ``optimizer``: the optimizer's ``state_dict``, with ``OptaxAdam``'s
  per-group update ``count`` and its per-parameter step tensors, without
  which a resumed Adam would take other bias corrections;
- ``schedule``: the learning-rate schedule's ``state_dict``;
- ``step``: ``TrainState.step``.

A step is written under a temporary name and renamed into place, so a run
killed while saving leaves no partial step that ``latest_step`` would pick
up (Orbax commits its steps atomically too). Saving is synchronous, so
``wait`` has nothing to wait for. Steps are kept as Orbax keeps them: a
step is saved when it is a multiple of ``save_interval_steps`` or the
directory holds none yet, never at or below the latest step, and only the
newest ``max_to_keep`` stay.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from hocon_torch.train.state import TrainState

_FILE = "state.pt"
_TMP = ".tmp-"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """Committed steps, oldest first."""
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, _FILE))
        )

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return not steps or step % self.save_interval_steps == 0

    def save(self, step: int, state: TrainState) -> bool:
        """Write ``state`` as ``step``; returns whether it was saved."""
        if not self.should_save(step):
            return False
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "schedule": state.schedule.state_dict(),
            "step": int(state.step),
        }
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _FILE))
        os.rename(tmp, os.path.join(self.directory, str(step)))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def wait(self):
        """Saves are synchronous: nothing is pending."""

    def _load(self, step: Optional[int], device: torch.device) -> dict:
        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), _FILE),
                          map_location=device, weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load model, optimizer, schedule and step of ``step`` (the latest
        when None) into ``state``, on the model's device."""
        device = next(state.model.parameters()).device
        raw = self._load(step, device)
        state.model.load_state_dict(raw["model"])
        state.optimizer.load_state_dict(raw["optimizer"])
        state.schedule.load_state_dict(raw["schedule"])
        state.step = int(raw["step"])
        return state

    def restore_params_only(self, state: TrainState,
                            step: Optional[int] = None) -> TrainState:
        """Warm start: load parameters and batch-norm statistics, keep the
        fresh optimizer state. Partial, as the reference's non-strict
        reload: a tensor loads where its key is in both the checkpoint and
        the model with equal shapes; checkpoint-only keys are dropped and
        model-only keys keep their values, so checkpoints transfer across
        model variants (hand + object baseline -> hand-only warp stage)."""
        device = next(state.model.parameters()).device
        source = self._load(step, device)["model"]
        target = state.model.state_dict()
        params = {k for k, _ in state.model.named_parameters()}
        merged, skipped, n_params = {}, [], 0
        for k, v in target.items():
            if k not in source:
                skipped.append(f"{k} (missing)")
            elif tuple(source[k].shape) != tuple(v.shape):
                skipped.append(f"{k} (shape mismatch)")
            else:
                merged[k] = source[k].to(v.dtype)
                n_params += k in params
        if n_params == 0:
            raise ValueError("warm start matched zero parameter arrays")
        if skipped:
            print(f"[hocon] warm start: skipped {len(skipped)} unmatched "
                  f"arrays (e.g. {skipped[:3]})")
        state.model.load_state_dict(merged, strict=False)
        return state


def restore_for_warm_start(directory: str, state: TrainState) -> TrainState:
    mgr = CheckpointManager(directory)
    if mgr.latest_step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return mgr.restore_params_only(state)
