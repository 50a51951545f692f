"""The comparison that decides ``correct`` for a training cell.

Set-up drives the system's train state from the seed through its first three
steps, on three distinct batches of the pool, through the same call and feed
as the window. The plain reference follows those three steps from the same
weights and batches, in float32 with TF32 off. Per parameter, a gap is the
difference between the system's norm and the reference's, over the
reference's norm or the median parameter's, whichever is larger. Read after
the window:

- ``loss_gap``: the largest relative gap of a step's loss over the three
  (``loss_gap_first``: the first step's alone);
- ``grad_gap_worst``, ``grad_gap_mean`` and ``grad_gap_median``: the worst
  parameter's gap, the mean and the median over the parameters, of the first
  step's gradient as the optimizer got it (its first moment after one step,
  over 1 − β1);
- ``change_gap_worst`` and ``change_gap_median``: the same of the change over
  the three steps.

Parameters whose reference gradient is under a thousandth of the median
parameter's are left out of both: their gradient is nought but for rounding (a
bias under a norm that removes it), so the system's is the rounding of a sum
that cancels, and Adam moves them by round-off alone.
- ``nonfinite_steps``: steps of the window whose loss is not finite.

A cell's ``checks/<workload>.json`` gives the limit of each number it
compares, with the readings the limit was set from; the others are reported
beside them and not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

EXCLUDE_BELOW = 1e-3  # of the median parameter's reference gradient norm


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


def gaps(ours: Dict[str, float], ref: Dict[str, float], names: List[str]) -> List[float]:
    median = statistics.median(ref[n] for n in names)
    return [abs(ours[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names]


def readings(program: Dict, reference: Dict) -> Dict:
    """``program`` and ``reference``: ``losses`` (three floats), ``first_grads``
    and ``change`` (``{name: norm}``). Returns the compared numbers, the median
    parameter's gaps and the names of the worst parameters."""
    ref_grads = reference["first_grads"]
    names = sorted(ref_grads)
    median = statistics.median(ref_grads[n] for n in names)
    moved = [n for n in names if ref_grads[n] >= EXCLUDE_BELOW * median]
    grad = gaps(program["first_grads"], ref_grads, moved)
    change = gaps(program["change"], reference["change"], moved)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"])),
        "loss_gap_first": abs(program["losses"][0] - reference["losses"][0]) / abs(reference["losses"][0]),
        "grad_gap_mean": statistics.fmean(grad),
        "grad_gap_median": statistics.median(grad),
        "change_gap_median": statistics.median(change),
        "grad_gap_worst": max(grad),
        "change_gap_worst": max(change),
        "grad_worst_leaf": moved[grad.index(max(grad))],
        "change_worst_leaf": moved[change.index(max(change))],
    }


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit at or under it (a NaN is over any limit)."""
    return all(values[k] <= limit for k, limit in limits.items())
