"""Train and eval steps for one GPU.

Counterpart of ``simpledepthestimation_tpu/parallel/train_step.py`` as far as
one device goes: no mesh, no sharding, no buffer donation (PyTorch updates the
parameters in place as it stands). The warp-window policy of the JAX step
schedules its TPU warp kernels and has no counterpart here: the CUDA warp
gathers directly and has no window.

    state = create_train_state(cfg, steps_per_epoch=n)     # on the card
    step = make_train_step(state, grad_clip=cfg.SOLVER.GRAD_CLIP,
                           schedule_fn=None)     # MotionLearning: models.make_schedule_fn(cfg)
    metrics = step(batch)        # dict of 0-d device tensors, no host sync

Semantics kept from the JAX step: the total loss is the sum of the model's
outputs whose key contains ``"loss"``; ``grad_norm`` is the global 2-norm over
all gradients, reported whether or not clipping is on; clipping scales every
gradient by ``min(1, clip / (norm + 1e-12))``. With bfloat16 convolutions the
parameters, their gradients and the optimizer state stay float32. The noise a
model draws in training (RandLayerNorm) comes from the state's own
``noise_generator``, never from the global random state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn

from ..models.build import build_model
from ..models.pretrained import maybe_load_pretrained_encoder
from ..solver.build import ScheduledLR, build_optimizer


@dataclass
class TrainState:
    """What a training run carries from step to step. ``step`` counts the
    updates applied; parameters, running statistics and optimizer moments live
    in ``model`` and ``optimizer`` and are updated in place.
    ``pretrained_weights`` is the ImageNet weight file found for the encoder
    (``None``: none in reach, or none asked for)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: ScheduledLR
    noise_generator: torch.Generator
    step: int = 0
    pretrained_weights: Optional[str] = None


def create_train_state(
    cfg,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
    steps_per_epoch: int = 1,
) -> TrainState:
    """Build the model (on the CUDA device unless another is named; see
    :func:`..models.build.build_model`), its optimizer, its schedule and the
    generator of its training noise: a ``torch.Generator`` on the model's
    device seeded with ``cfg.SEED`` (0 where that is negative). ``generator``
    is the CPU generator of the weight initialisation.

    An encoder name with the ``pt`` suffix (``"18pt"``) gets its ImageNet
    weights here, between the model and its optimizer, from a local file
    (:func:`..models.pretrained.maybe_load_pretrained_encoder`; without one it
    keeps the seeded weights and warns). The JAX package does this in
    ``engine.runtime.do_train`` right after making the state; the call moves
    there when the port has its own ``do_train``."""
    model = build_model(cfg, device=device, generator=generator)
    weights = maybe_load_pretrained_encoder(cfg, model)
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch)
    model_device = next(model.parameters()).device
    noise = torch.Generator(device=model_device).manual_seed(max(int(cfg.get("SEED", 0)), 0))
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler, noise_generator=noise, step=0,
                      pretrained_weights=weights)


def make_train_step(
    state: TrainState,
    grad_clip: float = 0.0,
    schedule_fn: Optional[Callable[[int], Dict[str, float]]] = None,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``: one forward, backward and update of ``state``.

    ``batch`` lies on the model's device. ``schedule_fn(state.step)`` (e.g.
    :func:`..models.motion_meta_arch.make_schedule_fn`) gives per-step scalars
    that the step adds to the batch as 0-d float32 tensors on the device, made
    by a fill kernel rather than a copy from the host, so the step never waits
    for the card for them.
    ``metrics`` holds ``total_loss``, ``grad_norm`` and every entry of the
    model's loss dict as detached 0-d tensors on that device; nothing in the
    step waits for the device."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    device = params[0].device

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if schedule_fn is not None:
            extra = schedule_fn(state.step)
            batch = {**batch, **{k: torch.full((), v, dtype=torch.float32, device=device)
                                 for k, v in extra.items()}}
        state.optimizer.zero_grad(set_to_none=True)
        outputs = state.model(batch, train=True, generator=state.noise_generator)
        total = torch.stack([v for k, v in outputs.items() if "loss" in k]).sum()
        total.backward()

        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        if grad_clip > 0.0:
            scale = torch.clamp(grad_clip / (grad_norm + 1e-12), max=1.0)
            for g in grads:
                g.mul_(scale)

        state.optimizer.step()
        state.scheduler.step()
        state.step += 1

        metrics = {"total_loss": total.detach(), "grad_norm": grad_norm}
        metrics.update({k: v.detach() for k, v in outputs.items()})
        return metrics

    return step


def make_eval_step(state: TrainState) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """``eval_step(batch) -> depth_pred`` with the running statistics, no grad."""

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return state.model(batch, train=False)["depth_pred"]

    return eval_step
