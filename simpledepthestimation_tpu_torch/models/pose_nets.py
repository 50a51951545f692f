"""Pose networks.

``PoseNet`` — counterpart of the class of that name in
``simpledepthestimation_tpu/models/pose_nets.py``: SfmLearner-style 7-conv
stack → global mean → 0.01× 6-DoF per context. The mean over the feature map
and ``pose_vec2mat`` run in float32.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from .build import POSE_NET_REGISTRY, compute_dtype
from .layers import ConvGNReLU
from .norm_layers import Conv2d
from ..geometry.pose import pose_vec2mat


@POSE_NET_REGISTRY.register()
class PoseNet(nn.Module):
    """7 stride-2 convs on concat(target, contexts) → per-context SE(3)."""

    def __init__(self, num_contexts: int = 2, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_contexts = num_contexts
        channels = (16, 32, 64, 128, 256, 256, 256)
        kernels = (7, 5, 3, 3, 3, 3, 3)
        in_ch = 3 * (1 + num_contexts)
        for i, (ch, k) in enumerate(zip(channels, kernels), start=1):
            setattr(self, f"conv{i}", ConvGNReLU(in_ch, ch, k, stride=2, compute_dtype=compute_dtype))
            in_ch = ch
        self.pose_pred = Conv2d(in_ch, 6 * num_contexts, 1, compute_dtype=compute_dtype)

    @classmethod
    def from_cfg(cls, cfg):
        return cls(num_contexts=int(cfg.MODEL.POSE_NET.NUM_CONTEXTS), compute_dtype=compute_dtype(cfg))

    def forward(self, pose_input: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        """pose_input: [B,3*(1+num_contexts),H,W]. Returns num_contexts × [B,4,4]."""
        x = pose_input
        for i in range(1, 8):
            x = getattr(self, f"conv{i}")(x)
        pose = self.pose_pred(x).float().mean(dim=(2, 3))  # [B, 6*N]
        pose = 0.01 * pose.reshape(pose.shape[0], self.num_contexts, 6)
        return [pose_vec2mat(pose[:, i]) for i in range(self.num_contexts)]
