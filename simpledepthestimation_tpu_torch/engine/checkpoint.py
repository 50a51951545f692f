"""Checkpoints with ``torch.save``: the port's counterpart of
``simpledepthestimation_tpu/engine/checkpoint.py`` (Orbax there).

One file per saved epoch, ``OUTPUT_DIR/model_{epoch:04d}.pth``, and a
``last_checkpoint`` file naming the newest. A file holds everything a
resumed run needs to continue exactly as an uninterrupted one would:

- ``model``: the ``state_dict``, running statistics included;
- ``optimizer`` and ``scheduler``: the optimizer's moments and step counts,
  and the ``ScheduledLR`` count;
- ``step``: ``TrainState.step``, the updates applied, which drives the
  schedules (MotionLearning's noise ramp and motion burn-in among them);
- ``noise_generator``: the state of the generator of the training noise
  (RandLayerNorm);
- ``epoch``: the last finished epoch.

Loading is non-strict, as the JAX package's is: where the stored model and
the live one differ, the tensors present in both with equal shapes are
loaded, the rest are logged as missing or unexpected, and the optimizer is
left as it is (the model views differ, so its state does not apply).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.train_step import TrainState

logger = logging.getLogger(__name__)

_LAST = "last_checkpoint"


def _load_file(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_weights(model: torch.nn.Module, stored: Dict[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """Load the tensors of ``stored`` whose name and shape match ``model``'s
    ``state_dict``; returns (missing, unexpected) names and logs both."""
    live = model.state_dict()
    missing, usable = [], {}
    for k, v in live.items():
        if k not in stored:
            missing.append(k)
        elif tuple(stored[k].shape) != tuple(v.shape):
            missing.append(f"{k} (shape {tuple(stored[k].shape)} vs expected {tuple(v.shape)})")
        else:
            usable[k] = stored[k]
    unexpected = [k for k in stored if k not in live]
    model.load_state_dict(usable, strict=False)
    if missing:
        logger.warning(f"Keys in the model but not the checkpoint (kept as they were): {missing[:20]}"
                       + (" ..." if len(missing) > 20 else ""))
    if unexpected:
        logger.info(f"Checkpoint keys unused by this model: {unexpected[:20]}"
                    + (" ..." if len(unexpected) > 20 else ""))
    return missing, unexpected


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # -- save --------------------------------------------------------------
    def save(self, epoch: int, state: TrainState) -> str:
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": int(state.step),
            "noise_generator": state.noise_generator.get_state(),
            "epoch": int(epoch),
        }
        name = f"model_{epoch:04d}.pth"
        path = os.path.join(self.directory, name)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.directory, _LAST), "w") as f:
            f.write(name)
        logger.info(f"Saved checkpoint at epoch {epoch} to {path}")
        return path

    # -- load --------------------------------------------------------------
    def latest(self) -> Optional[str]:
        """Path of the newest checkpoint, or None."""
        pointer = os.path.join(self.directory, _LAST)
        if not os.path.isfile(pointer):
            return None
        with open(pointer) as f:
            path = os.path.join(self.directory, f.read().strip())
        return path if os.path.isfile(path) else None

    def has_checkpoint(self) -> bool:
        return self.latest() is not None

    def resume_or_load(self, weights_path: str, state: TrainState, resume: bool = True) -> Tuple[TrainState, int]:
        """With ``resume`` and a checkpoint in the directory, restore all of it
        into ``state`` (in place) and return ``(state, epoch + 1)``; otherwise
        load the weights of ``weights_path`` (if any) and return ``(state, 0)``.
        A checkpoint whose model differs from the live one restores the
        matching tensors only, logs the rest, and keeps the optimizer, the
        counters and the generator as they were."""
        path = self.latest() if resume else None
        if path is not None:
            ckpt = _load_file(path)
            missing, unexpected = load_model_weights(state.model, ckpt["model"])
            if missing or unexpected:
                logger.warning(f"Partially resumed from {path}: the model differs, the optimizer state is not restored")
            else:
                state.optimizer.load_state_dict(ckpt["optimizer"])
                state.scheduler.load_state_dict(ckpt["scheduler"])
                state.step = int(ckpt["step"])
                state.noise_generator.set_state(ckpt["noise_generator"])
                logger.info(f"Resumed from {path} (epoch {ckpt['epoch']}, step {state.step})")
            return state, int(ckpt["epoch"]) + 1
        if weights_path:
            load_weights(weights_path, state)
        return state, 0


def load_weights(path: str, state: TrainState) -> TrainState:
    """Weights only, non-strict: ``path`` is a checkpoint directory (its newest
    file), a checkpoint file of this package, or a bare ``state_dict``."""
    if os.path.isdir(path):
        latest = Checkpointer(path).latest()
        if latest is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = latest
    stored = _load_file(path)
    if isinstance(stored.get("model"), dict):
        stored = stored["model"]
    load_model_weights(state.model, stored)
    logger.info(f"Loaded weights from {path}")
    return state


class PeriodicCheckpointer:
    """Save every ``period`` epochs and at the last one."""

    def __init__(self, checkpointer: Checkpointer, period: int, max_epoch: int):
        self.checkpointer = checkpointer
        self.period = max(int(period), 1)
        self.max_epoch = max_epoch

    def step(self, epoch: int, state: TrainState) -> None:
        if (epoch + 1) % self.period == 0 or (epoch + 1) >= self.max_epoch:
            self.checkpointer.save(epoch, state)
