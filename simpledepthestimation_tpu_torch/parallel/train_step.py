"""Train and eval steps, on one card or in several processes.

Counterpart of ``simpledepthestimation_tpu/parallel/train_step.py``: no
sharding and no buffer donation (PyTorch updates the parameters in place as it
stands). The warp-window policy of the JAX step schedules its TPU warp kernels
and has no counterpart here: the CUDA warp gathers directly and has no window.

In several processes (``torch.distributed`` initialised; ``mesh``) each rank
steps on its own rows of the global batch with a full copy of the state, and
the step computes what world 1 computes on the global batch, as the JAX
package's one program over the global batch does: every loss and BatchNorm
statistic is the global batch's, the backward is seeded with ``1/world``, and
the gradients are summed over ranks (coalesced into flat buckets) before
``grad_norm`` and the clip, so that every rank applies the same update. The
reduction is written by hand rather than taken from ``DistributedDataParallel``,
which averages (the rule here sums), broadcasts buffers, needs
``find_unused_parameters`` for the parameters ``BtsModel`` freezes (they get
gradients and count in ``grad_norm``) and hooks into the per-block checkpoints
of ``remat``.

    state = create_train_state(cfg, steps_per_epoch=n)     # on the card
    step = make_train_step(state, grad_clip=cfg.SOLVER.GRAD_CLIP,
                           schedule_fn=None)     # MotionLearning: models.make_schedule_fn(cfg)
    metrics = step(batch)        # dict of 0-d device tensors, no host sync

Semantics kept from the JAX step: the total loss is the sum of the model's
outputs whose key contains ``"loss"``; ``grad_norm`` is the global 2-norm over
all gradients, the frozen parameters' included (``BtsModel``; they are in no
optimizer group), reported whether or not clipping is on; clipping scales every
gradient by ``min(1, clip / (norm + 1e-12))``. With bfloat16 convolutions the
parameters, their gradients and the optimizer state stay float32. The noise a
model draws in training (RandLayerNorm) comes from the state's own
``noise_generator``, never from the global random state. ``remat``
(``TPU.REMAT``) keeps only the inputs of the nets' blocks (each class that sets
``remat_unit``: residual blocks, dense layers, decoder stages) and recomputes a
block's forward when the backward reaches it (``torch.utils.checkpoint``,
non-reentrant, one block at a time, so the peak memory falls: one checkpoint
around the whole model, as the JAX package's ``jax.checkpoint`` is placed, would
recompute every activation at once at the start of the backward). Memory
changes, the result does not: the recomputation replays the same noise and
leaves the BatchNorm running statistics as the forward left them.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Union

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..models.build import build_model, resolve_device
from ..models.norm_layers import BatchNorm2d, statistics_frozen
from ..models.pretrained import maybe_load_pretrained_encoder
from ..solver.build import ScheduledLR, build_optimizer
from ..utils.tracing import span
from . import mesh


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
    model: Optional[nn.Module] = None,
    warm_start: bool = True,
) -> TrainState:
    """Build the model (on the CUDA device unless another is named; see
    :func:`..models.build.build_model`), its optimizer, its schedule and the
    generator of its training noise: a ``torch.Generator`` on the model's
    device seeded with ``cfg.SEED`` (0 where that is negative). ``generator``
    is the CPU generator of the weight initialisation. A ``model`` built by
    the caller (e.g. with weights loaded) is moved to the device and used
    instead.

    An encoder name with the ``pt`` suffix (``"18pt"``) or of the BTS zoo
    (``"resnet50_bts"``) gets its ImageNet weights here, between the model and
    its optimizer (which leaves out the parameters ``BtsModel`` freezes), from
    a local file
    (:func:`..models.pretrained.maybe_load_pretrained_encoder`; without one it
    keeps the seeded weights and warns). The JAX package does this in
    ``engine.runtime.do_train`` right after making the state; the port's
    ``engine.runtime.do_train`` gets it by making its state here, before it
    resumes or loads ``MODEL.WEIGHTS``, the same order. ``warm_start=False``
    skips it: the JAX package's ``DefaultTrainer`` never loads one, and
    ``engine.trainer.DefaultTrainer`` follows it."""
    if model is None:
        model = build_model(cfg, device=device, generator=generator)
    else:
        model = model.to(resolve_device(device))
    weights = maybe_load_pretrained_encoder(cfg, model) if warm_start else None
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch)
    model_device = next(model.parameters()).device
    noise = torch.Generator(device=model_device).manual_seed(max(int(cfg.get("SEED", 0)), 0))
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler, noise_generator=noise, step=0,
                      pretrained_weights=weights)


def _recompute_contexts(generator: Optional[torch.Generator]):
    """``context_fn`` of ``torch.utils.checkpoint``: the forward context notes
    the noise generator's state as the block's forward found it, and how many
    batches its input stacks (``mesh.stacked``); the recompute context replays
    from there with the BatchNorm running statistics frozen, and gives the
    generator back the state it had when the recomputation began (also where
    the recomputation stops early)."""
    before = {}

    @contextlib.contextmanager
    def forward():
        if generator is not None:
            before["state"] = generator.get_state()
        before["blocks"] = mesh.current_blocks()
        yield

    @contextlib.contextmanager
    def recompute():
        current = None if generator is None else generator.get_state()
        if generator is not None:
            generator.set_state(before["state"])
        try:
            with statistics_frozen(), mesh.stacked(before["blocks"]):
                yield
        finally:
            if generator is not None:
                generator.set_state(current)

    return forward(), recompute()


def _checkpointed(forward, generator, *args, **kwargs):
    return torch.utils.checkpoint.checkpoint(
        forward, *args, use_reentrant=False, preserve_rng_state=False,  # the port draws from no global generator
        context_fn=functools.partial(_recompute_contexts, generator), **kwargs)


@contextlib.contextmanager
def _rematerialised(model: nn.Module, generator: Optional[torch.Generator]):
    """Within this context every block of ``model`` whose class sets
    ``remat_unit`` (the outermost, where one holds another) runs under
    :func:`torch.utils.checkpoint.checkpoint`; the blocks' own ``forward``
    comes back on exit (the backward that recomputes them runs the one it
    captured)."""
    blocks, prefixes = [], []
    for name, m in model.named_modules():
        if getattr(type(m), "remat_unit", False) and not any(name.startswith(p) for p in prefixes):
            blocks.append(m)
            prefixes.append(name + ".")
    for m in blocks:
        m.forward = functools.partial(_checkpointed, m.forward, generator)
    try:
        yield
    finally:
        for m in blocks:
            del m.forward


def make_train_step(
    state: TrainState,
    grad_clip: float = 0.0,
    schedule_fn: Optional[Callable[[int], Dict[str, float]]] = None,
    remat: bool = False,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``: one forward, backward and update of ``state``.

    ``batch`` lies on the model's device. ``schedule_fn(state.step)`` (e.g.
    :func:`..models.motion_meta_arch.make_schedule_fn`) gives per-step scalars
    that the step adds to the batch as 0-d float32 tensors on the device, made
    by a fill kernel rather than a copy from the host, so the step never waits
    for the card for them.
    ``metrics`` holds ``total_loss``, ``grad_norm`` and every entry of the
    model's loss dict as detached 0-d tensors on that device; nothing in the
    step waits for the device. ``remat``: keep the blocks' inputs only and
    recompute their forward in the backward (``TPU.REMAT``, :func:`_rematerialised`).
    In several processes ``batch`` is the rank's rows of the global batch, the
    metrics are the global batch's, equal on every rank, and so is the update.
    Under a profiler the forward, the backward and the grad norm are spans
    (:func:`..utils.tracing.span`); Adam has PyTorch's own."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    device = params[0].device

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if schedule_fn is not None:
            extra = schedule_fn(state.step)
            batch = {**batch, **{k: torch.full((), v, dtype=torch.float32, device=device)
                                 for k, v in extra.items()}}
        state.model.zero_grad(set_to_none=True)  # the frozen parameters are in no optimizer group
        with span("train_step.forward"):
            with _rematerialised(state.model, state.noise_generator) if remat else contextlib.nullcontext():
                outputs = state.model(batch, train=True, generator=state.noise_generator)
            total = torch.stack([v for k, v in outputs.items() if "loss" in k]).sum()
        with span("train_step.backward"):
            mesh.backward(total)
            grads = [p.grad for p in params if p.grad is not None]
            mesh.sum_gradients(grads)
        with span("train_step.grad_norm"):
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


def compute_precise_bn_stats(state: TrainState, batches: Iterable[Dict[str, torch.Tensor]]) -> int:
    """Replace the running statistics of every BatchNorm of ``state.model`` that
    updates them by their true average over ``batches`` (train-mode forwards
    under ``no_grad``, on the model's device); returns the number of batches.

    The counterpart of the JAX package's ``compute_precise_bn_stats`` (and of
    fvcore's ``update_bn_stats`` behind the original code's ``PreciseBN``
    hook): forward ``i`` (from 0) runs with momentum ``1/(i+1)``, so the
    statistics after ``n`` forwards are the mean of the ``n`` batches' (the
    first forward overwrites them). The JAX package gets the same mean as
    ``mean(z_i)/(1 − m)`` from forwards that start at zero; the two agree up to
    rounding. The batches' variance is the biased one, as in training.
    A BatchNorm that does not update (``BN_NO_TRACK`` runs it on its stored
    statistics) keeps them to the bit; momenta and ``num_batches_tracked`` are
    left as they were. The forwards draw their noise (RandLayerNorm) from a
    generator of their own seeded 0, so ``state.noise_generator`` is not moved.
    On MonoDepth2 each forward computes the loss, and so launches the warp and
    photometric kernels as a validation-loss pass does. The forwards run
    under ``mesh.per_rank()``: in several processes each rank's statistics
    are its own batches' and no collective is issued, as the JAX package's
    process-local forwards compute them; ``engine.hooks.PreciseBN`` then
    takes their mean over ranks."""
    model = state.model
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    if not norms:
        return 0
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(0)
    momenta = [m.momentum for m in norms]
    counts = [m.num_batches_tracked.clone() for m in norms]
    n = 0
    try:
        with torch.no_grad(), mesh.per_rank():
            for batch in batches:
                for m in norms:
                    m.momentum = 1.0 / (n + 1)
                model(batch, train=True, generator=generator)
                n += 1
    finally:
        for m, momentum, count in zip(norms, momenta, counts):
            m.momentum = momentum
            m.num_batches_tracked.copy_(count)
    return n
