"""Depth networks.

``DepthResNet`` — counterpart of the class of that name in
``simpledepthestimation_tpu/models/depth_nets.py``: ResNet encoder + U-Net
decoder, softplus disparity at 4 scales mapped through ``disp_to_depth`` (in
float32) to [0.1, MAX_DEPTH], with a per-sample boolean horizontal flip.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from .build import DEPTH_NET_REGISTRY, compute_dtype
from .depth_decoder import DepthDecoder
from .layers import disp_to_depth
from .resnet import ResNetEncoder
from ..geometry.camera import resize_img


def parse_encoder_version(version) -> Tuple[int, bool]:
    """'18pt' → (18, pretrained=True); '50' → (50, False). A bare CLI override
    like ``MODEL.DEPTH_NET.ENCODER_NAME 18`` literal-parses to an int — coerce."""
    version = str(version)
    num_layers = int(version[:2])
    pretrained = version[2:] == "pt"
    if num_layers not in (18, 34, 50):
        raise ValueError(f"ResNet version {num_layers} not available")
    return num_layers, pretrained


def flip_images(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontally flip samples where ``flip`` is True. x: [B,C,H,W], flip: [B] bool."""
    return torch.where(flip[:, None, None, None], x.flip(3), x)


@DEPTH_NET_REGISTRY.register()
class DepthResNet(nn.Module):
    def __init__(self, num_layers: int = 18, pretrained: bool = False, max_depth: float = 80.0,
                 upsample_depth: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        # an ImageNet warm start: models.pretrained loads it (parallel.create_train_state)
        self.pretrained = pretrained
        self.max_depth = max_depth
        self.upsample_depth = upsample_depth
        self.encoder = ResNetEncoder(num_layers, compute_dtype=compute_dtype)
        self.decoder = DepthDecoder(self.encoder.num_ch_enc, compute_dtype=compute_dtype)

    @classmethod
    def from_cfg(cls, cfg):
        num_layers, pretrained = parse_encoder_version(cfg.MODEL.DEPTH_NET.ENCODER_NAME)
        return cls(
            num_layers=num_layers,
            pretrained=pretrained,
            max_depth=float(cfg.MODEL.MAX_DEPTH),
            upsample_depth=bool(cfg.MODEL.DEPTH_NET.get("UPSAMPLE_DEPTH", False)),
            compute_dtype=compute_dtype(cfg),
        )

    def forward(self, image: torch.Tensor, flip: Optional[torch.Tensor] = None,
                train: bool = False, intrinsics: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """image: [B,3,H,W] normalized. Returns 4 float32 depth maps [B,1,h,w],
        index 0 = full resolution. ``intrinsics`` is accepted for interface
        uniformity with other depth nets and ignored here."""
        if flip is not None:
            image = flip_images(image, flip)
        disps = self.decoder(self.encoder(image, train=train))
        depths = []
        for i in range(4):
            _, depth = disp_to_depth(disps[i].float(), min_depth=0.1, max_depth=self.max_depth)
            depths.append(depth)
        if flip is not None:
            depths = [flip_images(d, flip) for d in depths]
        if self.upsample_depth:
            depths = [resize_img(d, image.shape[2:], mode="nearest") for d in depths]
        return depths
