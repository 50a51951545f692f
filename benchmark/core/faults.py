"""Programs that stand in for the system under test when the comparison is
calibrated and tested: the reference itself in a lower precision (the
control), and the system with a fault planted in its timed path.

Each is a ``build(cfg, weights, device, steps_per_epoch) -> (state, step)``
like ``drivers.train.build_program``: ``state`` has the ``model`` and the
``optimizer`` (Adam) that the checked steps read, and ``step(batch)`` returns
``{"total_loss": ...}``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import torch

from core.weights import load_into
from reference import monodepth2 as reference
from reference.nets import use_float8


def reference_in_float8(cfg, weights, device, steps_per_epoch):
    """The control: the plain reference in the program's place, its
    convolutions computed in float8 (the precision below the configurations'
    bfloat16), everything else in float32 without TF32, with Adam."""
    model = reference.build(cfg.to_dict()).to(device)
    use_float8(model)
    load_into(model, weights)
    lrs = reference.learning_rates(model, cfg.SOLVER)
    optimizer = torch.optim.Adam([{"params": [p], "lr": lrs[n]} for n, p in model.named_parameters()],
                                 eps=float(cfg.SOLVER.get("EPS", 1e-8)))

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        with reference.full_float32():
            loss = model(batch)
            loss.backward()
        optimizer.step()
        return {"total_loss": loss.detach()}

    return SimpleNamespace(model=model, optimizer=optimizer), step


def half_batch(build: Callable) -> Callable:
    """Half of the batch left out: the step sees its first half only, so every
    mean is taken over the rest."""

    def faulty(cfg, weights, device, steps_per_epoch):
        state, step = build(cfg, weights, device, steps_per_epoch)

        def half(batch):
            return step({k: v[: v.shape[0] // 2] for k, v in batch.items()})

        return state, half

    return faulty


def state_unchanged(build: Callable) -> Callable:
    """A step that returns its state unchanged: the optimizer applies nothing."""

    def faulty(cfg, weights, device, steps_per_epoch):
        state, step = build(cfg, weights, device, steps_per_epoch)
        state.optimizer.step = lambda *args, **kwargs: None
        return state, step

    return faulty
