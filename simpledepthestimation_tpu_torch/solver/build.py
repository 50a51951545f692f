"""Optimizers and learning-rate schedules.

Counterpart of ``simpledepthestimation_tpu/solver/build.py``: the same two
recipes, selected by ``SOLVER.OPT``, with ``torch.optim`` parameter groups in
place of ``optax.multi_transform`` labels.

- ``adam_multistep`` (MonoDepth2, MotionLearning): Adam with a ``depth`` group
  at ``DEPTH_LR`` and a ``pose`` group (every parameter under ``pose_net``) at
  ``POSE_LR``; the rate is multiplied by ``GAMMA`` at each epoch of
  ``LR_STEPS``, counted in steps (``epoch · steps_per_epoch``).
- ``adamw_poly`` (Supervised): AdamW (eps 1e-6) with weight decay on the
  ``encoder`` group only, and the poly decay
  ``(base − end)·(1 − step/max)^0.9 + end`` applied per step.

A schedule is a plain function of the step count. ``ScheduledLR.step()``,
called after ``optimizer.step()``, advances the count, so update ``k`` (from 0)
runs at ``schedule(k)``: the rate optax reads at the count before the update.

Frozen parameters (``BtsModel`` only, :func:`frozen_parameter_names`) are left
out of every group: no update, no weight decay. They keep ``requires_grad``, so
their gradients still enter the train step's ``grad_norm`` and clip scale, as
the JAX package's ``optax.set_to_zero`` after the clip has it.
"""

from __future__ import annotations

from typing import Callable, Collection, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

Schedule = Callable[[int], float]


def poly_lr_schedule(base_lr: float, end_lr: float, max_steps: int, power: float = 0.9) -> Schedule:
    """(base−end)·(1−step/max)^power + end, the fraction clipped to [0, 1]."""

    def schedule(step: int) -> float:
        frac = min(max(step / max(max_steps, 1), 0.0), 1.0)
        return (base_lr - end_lr) * (1.0 - frac) ** power + end_lr

    return schedule


def multistep_lr_schedule(base_lr: float, milestones: Sequence[int], gamma: float = 0.1) -> Schedule:
    """MultiStepLR: multiply by gamma at each milestone step reached."""

    def schedule(step: int) -> float:
        lr = base_lr
        for m in milestones:
            if step >= m:
                lr = lr * gamma
        return lr

    return schedule


class ScheduledLR:
    """Sets each parameter group's ``lr`` to its schedule's value at the step
    count. One schedule per group, in the optimizer's group order."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedules: Sequence[Schedule]):
        if len(schedules) != len(optimizer.param_groups):
            raise ValueError(
                f"{len(schedules)} schedules for {len(optimizer.param_groups)} parameter groups"
            )
        self.optimizer = optimizer
        self.schedules = list(schedules)
        self.last_step = 0
        self._apply()

    def _apply(self) -> None:
        for group, schedule in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = schedule(self.last_step)

    def step(self) -> None:
        self.last_step += 1
        self._apply()

    def get_last_lr(self) -> List[float]:
        return [group["lr"] for group in self.optimizer.param_groups]

    def state_dict(self) -> Dict[str, int]:
        return {"last_step": self.last_step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.last_step = int(state["last_step"])
        self._apply()


TRUNK = "depth_net.encoder.encoder."  # the torchvision-named encoder trunk


def _freeze_rules(cfg) -> List[Tuple[str, ...]]:
    """The frozen-parameter rules of the JAX package's ``freeze_substrings_from_cfg``
    over this package's parameter names: a rule is a tuple of substrings that
    must all occur in the dotted name. Only ``BtsModel`` freezes, and always:
    its encoder's stem conv and every encoder ``bn1``/``bn2``/``bn3`` affine pair
    (not the ``downsample.1`` BatchNorms, not the decoder); ``FIX_1ST_CONV`` adds
    the first residual block, ``FIX_1ST_CONVS`` the first two. DenseNet: ``conv0``
    and every norm (and the first one or two dense layers); MobileNetV2: nothing."""
    dn = cfg.MODEL.get("DEPTH_NET", {})
    if str(dn.get("NAME", "")) != "BtsModel":
        return []
    enc = str(dn.get("ENCODER_NAME", ""))
    if enc.startswith("mobilenet"):
        return []
    if "resne" in enc:
        rules = [(TRUNK + "conv1.",)] + [(TRUNK, f".bn{i}.") for i in (1, 2, 3)]
        first = [TRUNK + "layer1.0.", TRUNK + "layer1.1."]
    else:
        rules = [(TRUNK + "features.conv0.",), (TRUNK, "norm")]
        first = [TRUNK + f"features.denseblock1.denselayer{j}." for j in (1, 2)]
    if dn.get("FIX_1ST_CONVS", False):
        rules += [(f,) for f in first]
    elif dn.get("FIX_1ST_CONV", False):
        rules += [(first[0],)]
    return rules


def frozen_parameter_names(cfg, model: nn.Module) -> List[str]:
    """Names of ``model``'s parameters that a rule of :func:`_freeze_rules` selects."""
    rules = _freeze_rules(cfg)
    return [name for name, _ in model.named_parameters()
            if any(all(part in name + "." for part in rule) for rule in rules)]


def param_groups_by_name(
    model: nn.Module, groups: Dict[str, Sequence[str]], default: str, frozen: Collection[str] = ()
) -> Dict[str, List[nn.Parameter]]:
    """Sort the trainable parameters into named groups: a parameter belongs to
    the first group one of whose substrings occurs in its dotted name, else to
    ``default``. Parameters named in ``frozen``, or with ``requires_grad``
    off, belong to none. Every group is present in the result, in the order
    given, ``default`` last."""
    out: Dict[str, List[nn.Parameter]] = {label: [] for label in groups}
    out.setdefault(default, [])
    frozen = set(frozen)
    for name, p in model.named_parameters():
        if not p.requires_grad or name in frozen:
            continue
        label = next((lb for lb, subs in groups.items() if any(s in name for s in subs)), default)
        out[label].append(p)
    return out


def build_optimizer(cfg, model: nn.Module, steps_per_epoch: int) -> Tuple[torch.optim.Optimizer, ScheduledLR]:
    """Build the optimizer and its per-step schedule for ``cfg.SOLVER``.

    Each parameter group carries its ``name``. A group without parameters is
    left out (``torch.optim`` refuses an empty one). Frozen parameters
    (:func:`frozen_parameter_names`) are in no group."""
    solver = cfg.SOLVER
    frozen = frozen_parameter_names(cfg, model)
    max_steps = int(solver.MAX_EPOCHS) * steps_per_epoch
    opt_name = str(solver.get("OPT", "adam_multistep"))

    if opt_name == "adamw_poly":
        base_lr = float(solver.DEPTH_LR)
        # DEPTH_END_LR is the name the Supervised configs use; END_LR is an alias
        end_lr = float(solver.get("DEPTH_END_LR", solver.get("END_LR", base_lr * 0.1)))
        wd = float(solver.get("WEIGHT_DECAY", 1e-2))
        eps = float(solver.get("EPS", 1e-6))
        sched = poly_lr_schedule(base_lr, end_lr, max_steps)
        params = param_groups_by_name(model, {"encoder": ["encoder"]}, default="decoder", frozen=frozen)
        spec = [("encoder", wd, sched), ("decoder", 0.0, sched)]
        groups = [
            {"name": name, "params": params[name], "lr": s(0), "weight_decay": decay}
            for name, decay, s in spec if params[name]
        ]
        optimizer = torch.optim.AdamW(groups, lr=base_lr, eps=eps, weight_decay=0.0)
        schedules = [s for name, _, s in spec if params[name]]
        return optimizer, ScheduledLR(optimizer, schedules)

    if opt_name == "adam_multistep":
        depth_lr = float(solver.DEPTH_LR)
        pose_lr = float(solver.get("POSE_LR", depth_lr))
        milestones_epochs = solver.get("LR_STEPS", ())
        if isinstance(milestones_epochs, (int, float)):
            milestones_epochs = (milestones_epochs,)
        milestones = [int(m) * steps_per_epoch for m in milestones_epochs]
        gamma = float(solver.get("GAMMA", 0.1))
        eps = float(solver.get("EPS", 1e-8))
        params = param_groups_by_name(model, {"pose": ["pose_net"]}, default="depth", frozen=frozen)
        spec = [
            ("depth", multistep_lr_schedule(depth_lr, milestones, gamma)),
            ("pose", multistep_lr_schedule(pose_lr, milestones, gamma)),
        ]
        groups = [{"name": name, "params": params[name], "lr": s(0)} for name, s in spec if params[name]]
        optimizer = torch.optim.Adam(groups, lr=depth_lr, eps=eps)
        schedules = [s for name, s in spec if params[name]]
        return optimizer, ScheduledLR(optimizer, schedules)

    raise ValueError(f"Unknown SOLVER.OPT {opt_name!r}")
