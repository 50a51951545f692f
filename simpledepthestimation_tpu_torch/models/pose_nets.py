"""Pose networks.

Counterparts of the classes of these names in
``simpledepthestimation_tpu/models/pose_nets.py``:

- ``PoseNet``: SfmLearner-style 7-conv stack → global mean → 0.01× 6-DoF per
  context. The mean over the feature map and ``pose_vec2mat`` run in float32.
- ``GooglePoseNet``: two-frame RGB(-D) rigid pose, seven stride-2 conv stages
  (GroupNorm optional), the float32 spatial mean, a 1×1 float32 head with bias
  and learned translation and rotation scales.
- ``GoogleMotionNet``: two-frame RGB-D pose with learned rotation and
  translation scales, plus a dense residual translation field refined from a
  1×1 seed through every level of the trunk and then the input itself.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .build import POSE_NET_REGISTRY, compute_dtype
from .layers import ConvGNReLU
from .norm_layers import Conv2d
from ..parallel import mesh
from ..geometry.camera import resize_img
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
        self.pose_pred = Conv2d(in_ch, 6 * num_contexts, 1, compute_dtype=compute_dtype, xavier=True)

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


def _constrained_scale(raw: torch.Tensor, constraint: str, minval: float = 0.001) -> torch.Tensor:
    """Learned-scale reparameterisations: ``clip`` (ReLU above ``minval``),
    ``clip_ste`` (clipped forward, gradient straight through), ``softplus``."""
    if constraint == "clip":
        return F.relu(raw - minval) + minval
    if constraint == "clip_ste":
        return raw + (raw.clamp_min(minval) - raw).detach()
    if constraint == "softplus":
        return F.softplus(raw) * 0.01 + minval
    raise ValueError(constraint)


@POSE_NET_REGISTRY.register()
class GooglePoseNet(nn.Module):
    """Rigid pose of the second frame from the first: ``forward(pose_input
    [B,C,H,W])`` → [B,4,4] float32. The head's outputs are ordered (translation,
    rotation) and scaled by ``trans_scale`` / ``rot_scale`` (learned, 0.01 at
    init, through ``scale_constraint``) or by 0.01 when ``learn_scale`` is off."""

    def __init__(self, in_channels: int = 8, group_norm: bool = False, learn_scale: bool = True,
                 scale_constraint: str = "clip", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.learn_scale = learn_scale
        self.scale_constraint = scale_constraint
        ch = in_channels
        for i, (out_ch, k) in enumerate(zip((16, 32, 64, 128, 256, 256, 256), (7, 5, 3, 3, 3, 3, 3)), start=1):
            setattr(self, f"conv{i}", ConvGNReLU(ch, out_ch, k, 2, compute_dtype, group_norm))
            ch = out_ch
        self.pose_pred = Conv2d(ch, 6, 1, xavier=True)
        if learn_scale:
            self.rot_scale = nn.Parameter(torch.tensor(0.01))
            self.trans_scale = nn.Parameter(torch.tensor(0.01))
            self.param_init = {"rot_scale": 0.01, "trans_scale": 0.01}

    @classmethod
    def from_cfg(cls, cfg):
        pn = cfg.MODEL.POSE_NET
        return cls(
            in_channels=8 if bool(pn.get("USE_DEPTH", True)) else 6,
            group_norm=bool(pn.get("GROUP_NORM", False)),
            learn_scale=bool(pn.get("LEARN_SCALE", True)),
            scale_constraint=str(pn.get("SCALE_CONSTRAIN", "clip")),
            compute_dtype=compute_dtype(cfg),
        )

    def forward(self, pose_input: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = pose_input
        for i in range(1, 8):
            x = getattr(self, f"conv{i}")(x)
        pose = self.pose_pred(x.float().mean(dim=(2, 3), keepdim=True))[:, :, 0, 0]
        trans, rot = pose[:, :3], pose[:, 3:]
        if self.learn_scale:
            trans = trans * _constrained_scale(self.trans_scale, self.scale_constraint)
            rot = rot * _constrained_scale(self.rot_scale, self.scale_constraint)
        else:
            trans, rot = trans * 0.01, rot * 0.01
        return pose_vec2mat(torch.cat([trans, rot], dim=-1))


class MotionRefiner(nn.Module):
    """Refine the translation field against one feature level: bilinear resize
    of the field to the level, concat, two conv paths (``conv1``;
    ``conv21`` → ``conv22``), a bias-free Xavier 1×1 ``conv3`` to a residual."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_channels: int, channel_mid: int, group_norm: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.conv1 = ConvGNReLU(in_channels + 3, channel_mid, 3, 1, dt, group_norm)
        self.conv21 = ConvGNReLU(in_channels + 3, channel_mid, 3, 1, dt, group_norm)
        self.conv22 = ConvGNReLU(channel_mid, channel_mid, 3, 1, dt, group_norm)
        self.conv3 = Conv2d(2 * channel_mid, 3, 1, bias=False, compute_dtype=dt, xavier=True)

    def forward(self, trans: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = resize_img(trans, skip.shape[2:], mode="bilinear")
        inputs = torch.cat([up, skip], dim=1)
        combined = torch.cat([self.conv1(inputs), self.conv22(self.conv21(inputs))], dim=1)
        return up + self.conv3(combined).float()


@POSE_NET_REGISTRY.register()
class GoogleMotionNet(nn.Module):
    """Pose head + dense residual motion-field decoder.

    ``forward(pose_input [B,C,H,W], motion_weight)`` → (pose [B,4,4], motion
    [B,3,H,W] × ``motion_weight``), both float32. The pose vector is
    (translation·trans_scale, rotation·rot_scale) with the head's outputs
    ordered (rotation, translation). The pose head (bias-free) and the 1×1
    seed ``conv8`` compute in float32, as their JAX modules name no dtype.
    ``mask_motion`` keeps the pixels whose motion magnitude exceeds the mean
    magnitude over the whole batch (strictly).
    """

    CHANNELS = (16, 32, 64, 128, 256, 512, 1024)

    def __init__(self, in_channels: int = 8, group_norm: bool = False, learn_scale: bool = True,
                 mask_motion: bool = True, scale_constraint: str = "clip",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.learn_scale = learn_scale
        self.mask_motion = mask_motion
        self.scale_constraint = scale_constraint
        ch = in_channels
        for i, out_ch in enumerate(self.CHANNELS, start=1):
            setattr(self, f"conv{i}", ConvGNReLU(ch, out_ch, 3, 2, compute_dtype, group_norm))
            ch = out_ch
        self.pose_pred = Conv2d(ch, 6, 1, bias=False, xavier=True)
        self.conv8 = Conv2d(6, 3, 1, xavier=True)
        for lvl in range(7, 0, -1):
            mid = self.CHANNELS[lvl - 1]
            setattr(self, f"refiner{lvl}", MotionRefiner(mid, mid, group_norm, compute_dtype))
        self.refiner0 = MotionRefiner(in_channels, in_channels, False, compute_dtype)
        if learn_scale:
            init = 0.4 if scale_constraint == "softplus" else 0.01
            self.trans_scale = nn.Parameter(torch.tensor(init))
            self.rot_scale = nn.Parameter(torch.tensor(init))
            self.param_init = {"trans_scale": init, "rot_scale": init}

    @classmethod
    def from_cfg(cls, cfg):
        pn = cfg.MODEL.POSE_NET
        return cls(
            in_channels=8 if bool(pn.get("USE_DEPTH", True)) else 6,
            group_norm=bool(pn.get("GROUP_NORM", False)),
            learn_scale=bool(pn.get("LEARN_SCALE", True)),
            mask_motion=bool(pn.get("MASK_MOTION", True)),
            scale_constraint=str(pn.get("SCALE_CONSTRAIN", "clip")),
            compute_dtype=compute_dtype(cfg),
        )

    def forward(self, pose_input: torch.Tensor, motion_weight: Union[float, torch.Tensor] = 1.0,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = []
        x = pose_input
        for i in range(1, 8):
            x = getattr(self, f"conv{i}")(x)
            feats.append(x)
        pooled = x.float().mean(dim=(2, 3), keepdim=True)  # [B,1024,1,1]
        pose = self.pose_pred(pooled)  # [B,6,1,1]
        rot, trans = pose[:, :3, 0, 0], pose[:, 3:, 0, 0]

        motion = self.conv8(pose).float()  # [B,3,1,1]
        for lvl in range(7, 0, -1):
            motion = getattr(self, f"refiner{lvl}")(motion, feats[lvl - 1])
        motion = self.refiner0(motion, pose_input)

        if self.learn_scale:
            trans_scale = _constrained_scale(self.trans_scale, self.scale_constraint)
            rot_scale = _constrained_scale(self.rot_scale, self.scale_constraint)
        else:
            trans_scale = rot_scale = 0.01
        vec = torch.cat([trans * trans_scale, rot * rot_scale], dim=-1)
        motion = motion * trans_scale
        if self.mask_motion:
            mag = torch.sqrt((motion**2).sum(dim=1, keepdim=True))
            motion = motion * (mag > mesh.global_mean(mag.detach())).to(motion.dtype)  # the global batch's mean
        return pose_vec2mat(vec), motion * motion_weight
