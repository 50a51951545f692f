"""Inference export for serving, by ``torch.export``.

The port's counterpart of ``simpledepthestimation_tpu/engine/export.py``: the
depth inference of a trained checkpoint is traced to an ``ExportedProgram``
with the weights in it and saved with ``torch.export.save``; a serving process
loads it with :func:`load_exported` and calls it without the model's code.
Beside the artifact goes a ``.json`` sidecar with the JAX package's fields.

Layout: the input is NCHW ``[B, 3, H, W]`` float32 in [0, 1] and the output
depth ``[B, 1, H, W]``, the port's layout (the JAX package's artifact is NHWC);
the sidecar states both. The program's weights and its computation lie on the
device it was exported on, named in the sidecar's ``platforms``; the casts of
``TPU.COMPUTE_DTYPE`` are traced into it.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from ..config import CfgNode
from ..models.build import resolve_device
from .runtime import Device, restore_inference_state

logger = logging.getLogger(__name__)


class InferenceModule(nn.Module):
    """``forward(img [B,3,H,W]) -> depth [B,1,H,W]`` of a depth model, eval mode."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.model({"img": img}, train=False)["depth_pred"]


def build_inference_fn(cfg: CfgNode, allow_random_init: bool = False,
                       device: Device = None) -> Tuple[InferenceModule, Tuple[int, int]]:
    """``(infer, (H, W))``: the model with the weights of ``MODEL.WEIGHTS`` /
    ``OUTPUT_DIR`` as an :class:`InferenceModule`, and the test frame size.

    A serving export of untrained weights is almost always a config mistake
    (a wrong checkpoint path), so a missing checkpoint raises unless
    ``allow_random_init`` is set."""
    state, had_checkpoint = restore_inference_state(cfg, device)
    ckpt_dir = str(cfg.MODEL.WEIGHTS) or cfg.OUTPUT_DIR
    if not had_checkpoint:
        if not allow_random_init:
            raise FileNotFoundError(
                f"No checkpoint found under {ckpt_dir!r} (MODEL.WEIGHTS / OUTPUT_DIR); refusing to export "
                "random-init weights. Pass --allow-random-init / allow_random_init=True to override.")
        logger.warning(f"No checkpoint under {ckpt_dir!r}: exporting RANDOM-INIT weights")
    H, W = int(cfg.DATASETS.TEST.IMG_HEIGHT), int(cfg.DATASETS.TEST.IMG_WIDTH)
    return InferenceModule(state.model), (H, W)


def export_inference(
    cfg: CfgNode,
    output_path: str,
    batch: int = 1,
    shape: Optional[Tuple[int, int]] = None,
    allow_random_init: bool = False,
    device: Device = None,
) -> str:
    """Export the inference of ``cfg``'s checkpoint at ``[batch, 3, H, W]`` to
    ``output_path`` (and ``output_path + ".json"``); returns the path."""
    device = resolve_device(device)
    infer, (H, W) = build_inference_fn(cfg, allow_random_init=allow_random_init, device=device)
    if shape is not None:
        H, W = shape
    example = torch.zeros(batch, 3, H, W, dtype=torch.float32, device=device)
    with torch.no_grad():
        exported = torch.export.export(infer, (example,))

    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    torch.export.save(exported, output_path)
    with open(output_path + ".json", "w") as f:
        json.dump(
            {
                "input": {"shape": [batch, 3, H, W], "dtype": "float32", "layout": "NCHW"},
                "output": "depth [B,1,H,W] (meters)",
                "platforms": [device.type],
                "meta_architecture": str(cfg.MODEL.META_ARCHITECTURE),
                "depth_net": str(cfg.MODEL.DEPTH_NET.NAME),
            },
            f,
            indent=2,
        )
    logger.info(f"Exported {os.path.getsize(output_path) / 1e6:.1f} MB inference artifact ({device.type}) "
                f"to {output_path}")
    return output_path


def load_exported(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an artifact of :func:`export_inference`; returns ``fn(img) -> depth``,
    which moves ``img`` (a tensor or array, NCHW) to the program's device as
    float32."""
    module = torch.export.load(path).module()
    device = next(iter(module.state_dict().values())).device

    def run(img) -> torch.Tensor:
        with torch.no_grad():
            return module(torch.as_tensor(img, dtype=torch.float32).to(device))

    return run
