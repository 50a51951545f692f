"""ImageNet-pretrained encoder weights from a local torchvision ``.pth`` file.

Counterpart of ``simpledepthestimation_tpu/models/pretrained.py`` and of
``maybe_load_pretrained_encoder`` in ``simpledepthestimation_tpu/engine/runtime.py``.
An encoder name with the ``pt`` suffix (``"18pt"``, ``"50pt"``) or a BTS
encoder name of ``BTS_CONVERTIBLE`` (``resnet50_bts``, ``densenet121_bts``, …)
asks for an ImageNet warm start. Nothing is downloaded: the weight file is
``MODEL.DEPTH_NET.PRETRAINED_WEIGHTS`` where that names an existing file, else
``$SDE_TPU_PRETRAINED_DIR/{stem}.pth`` (``resnet18``, ``resnext50_32x4d``,
``densenet121``, ``mobilenet_v2``, …). Without one the encoder keeps its
seeded initialisation and a warning says so.

The port's encoders use torchvision's parameter names (``conv1``, ``bn1``,
``layer{L}.{b}.conv{c}``, ``….downsample.0`` / ``.1``; DenseNet and MobileNetV2
under ``features.``), so a torchvision ``state_dict`` loads key by key, without
transposes:

- a BatchNorm encoder (``ResNetEncoder`` of ``DepthResNet`` and ``BtsModel``,
  and the BTS zoo of ``models/encoders.py``) takes the convolutions, the BN
  affine parameters and the running statistics;
- a norm-agnostic encoder (``NormResNetEncoder`` of ``GoogleResNet``, whatever
  its norm) takes the convolution kernels only, as the JAX package's
  ``convert_torch_resnet_convs_only`` does: its norms keep their values.

The classifier (``fc.*``, ``classifier.*``) and ``num_batches_tracked`` are not
read. A file whose keys or shapes do not match the encoder (a DenseNet file with
torchvision's legacy ``norm.1`` keys among them, which the JAX package's
converter does not read either) leaves the encoder untouched (no half-loaded
encoder) and logs the JAX package's warning.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch
import torch.nn as nn

logger = logging.getLogger(__name__)

# BTS encoder name -> (torchvision weight-file stem, architecture named in the warnings)
BTS_CONVERTIBLE = {
    "resnet50_bts": ("resnet50", 50),
    "resnet101_bts": ("resnet101", 101),
    "resnext50_bts": ("resnext50_32x4d", 50),
    "resnext101_bts": ("resnext101_32x8d", 101),
    "densenet121_bts": ("densenet121", "densenet121"),
    "densenet161_bts": ("densenet161", "densenet161"),
    "mobilenetv2_bts": ("mobilenet_v2", "mobilenet_v2"),
}
CLASSIFIER_KEYS = ("fc.", "classifier.")


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
        if k.startswith(CLASSIFIER_KEYS) or k.endswith("num_batches_tracked") or (convs_only and v.dim() != 4):
            continue
        if k not in wanted:
            return f"unexpected key {k!r}"
    return None


def load_pretrained_encoder(encoder: nn.Module, num_layers, weights_file: Optional[str]) -> nn.Module:
    """Copy a torchvision ``state_dict`` (``weights_file``) into ``encoder`` in
    place and return it. ``encoder`` is a ``NormResNetEncoder`` (convolution
    kernels only) or any other encoder with a torchvision trunk in
    ``encoder.encoder`` (all of conv, BN and running statistics).
    ``num_layers`` (a layer count or an architecture name) names the encoder
    in the warnings. No file: a warning, the encoder as it was. A file that
    does not match: a warning, the encoder as it was."""
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
    ``"50pt"`` → ResNet-50, a name of ``BTS_CONVERTIBLE`` → its torchvision
    file), from :func:`find_pretrained_file`; otherwise leave the model as it
    is. A ``*_bts`` name outside ``BTS_CONVERTIBLE`` warns and loads nothing;
    so does a depth net with no torchvision-layout encoder (``GoogleResNetv2``
    accepts ``"18pt"``), as the JAX package's ``engine.runtime`` does on its
    layout mismatch. Returns the weight file found, or ``None`` (none found,
    or no such encoder)."""
    dn = cfg.MODEL.get("DEPTH_NET", {})
    version = str(dn.get("ENCODER_NAME", ""))
    if version.endswith("pt") and version[:2].isdigit():
        num_layers = int(version[:2])
        filename = f"resnet{num_layers}"
    elif version in BTS_CONVERTIBLE:
        filename, num_layers = BTS_CONVERTIBLE[version]
    else:
        if version.endswith("_bts"):
            logger.warning(f"No pretrained conversion for BTS encoder {version}; random init")
        return None
    weights_file = find_pretrained_file(num_layers, str(dn.get("PRETRAINED_WEIGHTS", "")), filename=filename)
    encoder = getattr(model.depth_net, "encoder", None)
    if weights_file and not isinstance(getattr(encoder, "encoder", None), nn.Module):
        # a depth net without a torchvision-layout encoder (GoogleResNetv2, PackNet01) accepts
        # the name, as the JAX package does, and trains from its initialisation
        logger.warning(f"Pretrained encoder injection skipped (layout mismatch): "
                       f"{type(model.depth_net).__name__} has no torchvision-layout encoder")
        return None
    load_pretrained_encoder(encoder, num_layers, weights_file)
    return weights_file
