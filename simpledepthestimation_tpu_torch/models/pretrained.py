"""ImageNet-pretrained encoder weights from a local torchvision ``.pth`` file.

Counterpart of the ResNet part of ``simpledepthestimation_tpu/models/pretrained.py``
and of ``maybe_load_pretrained_encoder`` in ``simpledepthestimation_tpu/engine/runtime.py``.
An encoder name with the ``pt`` suffix (``"18pt"``, ``"50pt"``) asks for an
ImageNet warm start. Nothing is downloaded: the weight file is
``MODEL.DEPTH_NET.PRETRAINED_WEIGHTS`` where that names an existing file, else
``$SDE_TPU_PRETRAINED_DIR/resnet{N}.pth``. Without one the encoder keeps its
seeded initialisation and a warning says so.

The port's encoders use torchvision's parameter names (``conv1``, ``bn1``,
``layer{L}.{b}.conv{c}``, ``….downsample.0`` / ``.1``), so a torchvision
``state_dict`` loads key by key, without transposes:

- a BatchNorm encoder (``ResNetEncoder`` of ``DepthResNet``) takes the
  convolutions, the BN affine parameters and the running statistics;
- a norm-agnostic encoder (``NormResNetEncoder`` of ``GoogleResNet``, whatever
  its norm) takes the convolution kernels only, as the JAX package's
  ``convert_torch_resnet_convs_only`` does: its norms keep their values.

``fc.*`` and ``num_batches_tracked`` are not read. A file whose keys or shapes
do not match the encoder leaves the encoder untouched (no half-loaded encoder)
and logs the JAX package's warning.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
import torch.nn as nn

logger = logging.getLogger(__name__)


def find_pretrained_file(num_layers: int, explicit: str = "", filename: str = "") -> Optional[str]:
    """The weight file: ``explicit`` where it is an existing file, else
    ``$SDE_TPU_PRETRAINED_DIR/{filename or resnet{num_layers}}.pth`` where that
    exists, else ``None``."""
    if explicit and os.path.isfile(explicit):
        return explicit
    base = os.environ.get("SDE_TPU_PRETRAINED_DIR", "")
    if base:
        cand = os.path.join(base, f"{filename or f'resnet{num_layers}'}.pth")
        if os.path.isfile(cand):
            return cand
    return None


def _wanted(trunk: nn.Module, convs_only: bool) -> Dict[str, torch.Tensor]:
    """The trunk's entries that a torchvision file gives, by torchvision name."""
    if convs_only:
        return {f"{name}.weight": m.weight for name, m in trunk.named_modules() if isinstance(m, nn.Conv2d)}
    return {k: v for k, v in trunk.state_dict().items() if not k.endswith("num_batches_tracked")}


def _mismatch(state_dict, wanted: Dict[str, torch.Tensor], convs_only: bool) -> Optional[str]:
    """What keeps ``state_dict`` from loading into ``wanted``, or ``None``. The
    file's entries of the trunk's layout must be those the trunk has (a
    ResNet-34 file on a ResNet-18 encoder does not load); convs-only, that is
    its convolution kernels (4-d)."""
    for k, v in wanted.items():
        if k not in state_dict:
            return f"missing key {k!r}"
        if tuple(state_dict[k].shape) != tuple(v.shape):
            return f"shape mismatch for {k}: {tuple(v.shape)} vs {tuple(state_dict[k].shape)}"
    for k, v in state_dict.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked") or (convs_only and v.dim() != 4):
            continue
        if k not in wanted:
            return f"unexpected key {k!r}"
    return None


def load_pretrained_encoder(encoder: nn.Module, num_layers: int, weights_file: Optional[str]) -> nn.Module:
    """Copy a torchvision ResNet ``state_dict`` (``weights_file``) into
    ``encoder`` in place and return it. ``encoder`` is a ``ResNetEncoder`` (all
    of conv, BN and running statistics) or a ``NormResNetEncoder`` (convolution
    kernels only). No file: a warning, the encoder as it was. A file that does
    not match: a warning, the encoder as it was."""
    if not weights_file:
        logger.warning(
            f"No ImageNet weights found for encoder {num_layers}; "
            "encoder starts from random init (set SDE_TPU_PRETRAINED_DIR "
            "or MODEL.DEPTH_NET.PRETRAINED_WEIGHTS for the warm start)."
        )
        return encoder
    from .google_resnet import NormResNetEncoder

    state_dict = torch.load(weights_file, map_location="cpu", weights_only=True)
    convs_only = isinstance(encoder, NormResNetEncoder)
    wanted = _wanted(encoder.encoder, convs_only)
    problem = _mismatch(state_dict, wanted, convs_only)
    if problem:
        logger.warning(f"Pretrained encoder injection skipped (layout mismatch): {problem}")
        return encoder
    with torch.no_grad():
        for k, v in wanted.items():
            v.copy_(state_dict[k])
    logger.info(f"Loaded ImageNet weights from {weights_file}")
    return encoder


def maybe_load_pretrained_encoder(cfg, model: nn.Module) -> Optional[str]:
    """Load ImageNet weights into ``model.depth_net.encoder`` when
    ``MODEL.DEPTH_NET.ENCODER_NAME`` asks for them (``"18pt"`` → ResNet-18,
    ``"50pt"`` → ResNet-50), from :func:`find_pretrained_file`; otherwise leave
    the model as it is. A BTS encoder name (``*_bts``) warns: its conversions
    are not ported. Returns the weight file found, or ``None``."""
    dn = cfg.MODEL.get("DEPTH_NET", {})
    version = str(dn.get("ENCODER_NAME", ""))
    if not (version.endswith("pt") and version[:2].isdigit()):
        if version.endswith("_bts"):
            logger.warning(f"No pretrained conversion for BTS encoder {version}; random init")
        return None
    num_layers = int(version[:2])
    weights_file = find_pretrained_file(num_layers, str(dn.get("PRETRAINED_WEIGHTS", "")),
                                        filename=f"resnet{num_layers}")
    load_pretrained_encoder(model.depth_net.encoder, num_layers, weights_file)
    return weights_file
