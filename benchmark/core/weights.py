"""Seeded weights, made on the device from ``--seed`` in one draw.

The same seed gives the same weights to the system under test and to the
reference: each is handed the tensors made here for the parameter names and
shapes of the reference (which the system's names have to match). Kernels of
two or more dimensions are N(0, 1/fan_in), as both packages initialise their
convolutions; one-dimensional parameters are a norm's scale (1) or a bias (0).
Overrides may then scale named parameters and set others to given values
(``{"scale": {name: factor}, "set": {name: [values]}}``): the pose head that
starts out predicting the mix's camera motion (``drivers.train.pose_head_start``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Tuple

import torch

WEIGHT_STREAM = 0x5EED_0001  # keeps the weights' draw apart from the traffic's for one seed


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + stream) % 2**63)


def seeded_weights(shapes: Iterable[Tuple[str, torch.Size]], seed: int, device,
                   overrides: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` on ``device`` for the ``(name, shape)`` pairs,
    with ``overrides`` (``{"scale": ..., "set": ...}``) applied."""
    shapes = sorted((name, tuple(shape)) for name, shape in shapes)
    kernels = [(name, shape) for name, shape in shapes if len(shape) >= 2]
    flat = torch.randn(sum(math.prod(s) for _, s in kernels), generator=generator(seed, WEIGHT_STREAM, device),
                       device=device)
    out, offset = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape) * math.sqrt(1.0 / math.prod(shape[1:]))
        offset += n
    for name, shape in shapes:
        if len(shape) < 2:
            fill = 1.0 if name.endswith("weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
    overrides = overrides or {}
    for name, factor in overrides.get("scale", {}).items():
        out[name] = out[name] * factor
    for name, values in overrides.get("set", {}).items():
        out[name] = torch.tensor(values, dtype=torch.float32, device=device).reshape(out[name].shape)
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; every parameter
    must be named there with the same shape, and no other name."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(weights) - set(params)), sorted(set(params) - set(weights))
        raise ValueError(f"parameter names differ: not in the module {missing[:5]}, not in the weights {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)} against {tuple(weights[name].shape)}")
            p.copy_(weights[name])
