"""Model registries and builders.

Counterpart of ``simpledepthestimation_tpu/models/build.py``: string names in
the yaml select the meta-architecture and its sub-nets. ``build_model`` is the
entry point: it places the model on the CUDA device unless the caller asks for
another one, and raises when no CUDA device is present.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn as nn

from ..utils.registry import Registry

META_ARCH_REGISTRY = Registry("META_ARCH")
DEPTH_NET_REGISTRY = Registry("DEPTH_NET")
POSE_NET_REGISTRY = Registry("POSE_NET")


def compute_dtype(cfg) -> torch.dtype:
    """Dtype of the convolutions, read from ``TPU.COMPUTE_DTYPE`` (the key both
    packages share). Parameters, norms, geometry, kernels and losses stay float32."""
    name = cfg.TPU.get("COMPUTE_DTYPE", "float32") if "TPU" in cfg else "float32"
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def build_depth_net(cfg) -> nn.Module:
    return DEPTH_NET_REGISTRY.get(cfg.MODEL.DEPTH_NET.NAME).from_cfg(cfg)


def build_pose_net(cfg) -> nn.Module:
    return POSE_NET_REGISTRY.get(cfg.MODEL.POSE_NET.NAME).from_cfg(cfg)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA device, and raises where there is none: the CPU
    is used only when asked for by name."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to build the model on the CPU"
        )
    return device


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation on the CPU, before the move to the device:
    2D and 3D convolutions N(0, 1/fan_in) with zero bias, or Xavier-uniform
    where the conv is marked ``xavier`` (the JAX modules' ``xavier_uniform``
    kernels: pose heads, the GoogleResNet decoder, the motion net's seed and
    refiner heads, every PackNet convolution; fan in and out over the whole
    window, as flax reckons them: 27 and 27·8 for the packed
    ``Conv3d(1, 8, 3)``); norm layers weight 1 / bias 0 / running statistics
    0 and 1; and every parameter that a module lists in its ``param_init`` dict (name →
    value: RandLayerNorm's weight and bias, the learned motion scales)."""
    for name, m in model.named_modules():
        for pname, value in getattr(m, "param_init", {}).items():
            with torch.no_grad():
                getattr(m, pname).fill_(value)
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            window = math.prod(m.kernel_size)
            fan_in = m.in_channels * window // m.groups
            with torch.no_grad():
                if getattr(m, "xavier", False):
                    fan_out = m.out_channels * window
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    m.weight.uniform_(-bound, bound, generator=generator)
                else:
                    m.weight.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()


def build_model(
    cfg,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Build the meta-architecture named by ``cfg.MODEL.META_ARCHITECTURE``.

    ``device=None`` → ``torch.device("cuda")``, raising without one.
    ``generator``: a CPU ``torch.Generator`` for the weight initialisation;
    default is a fresh one seeded with ``cfg.SEED`` (0 where that is negative).
    """
    device = resolve_device(device)
    model = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE).from_cfg(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(max(int(cfg.get("SEED", 0)), 0))
    init_weights(model, generator)
    return model.to(device)
