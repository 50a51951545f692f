"""Meta-architectures: the cfg-built top-level models.

Counterparts of ``SupDepthModel`` and ``MonoDepth2Model`` in
``simpledepthestimation_tpu/models/meta_arch.py`` (``MotionLearningModel`` is
in ``motion_meta_arch.py``).

Interface: ``model(batch, train=..., generator=None)`` where ``batch`` is a dict of NCHW
tensors on the model's device (``img``, ``img_orig`` [B,3,H,W]; ``ctx_img``,
``ctx_img_orig`` [B,N,3,H,W]; ``intrinsics`` [B,3,3]; optional ``flip`` [B]
bool, ``depth`` [B,1,H,W]). ``train=True`` returns a dict of scalar losses,
``train=False`` returns ``{"depth_pred": [B,1,H,W]}``. ``generator`` is the
source of any noise a model draws in training (none of the two here draws any).

``train`` selects the output **and** the BatchNorm mode (batch statistics and
running-statistics update when True), exactly as in the JAX modules. It is an
argument threaded down to every BatchNorm; ``nn.Module.train()`` / ``.eval()``
are not consulted, so a forward's behaviour never depends on hidden module
state. A validation-loss pass is ``model(batch, train=True)`` under
``torch.no_grad()``.

Dtypes: the convolutions run in the compute dtype (models/build.py); norms,
``disp_to_depth``, all of ``geometry/``, both kernels and every loss run in
float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from . import losses as L
from .build import META_ARCH_REGISTRY, build_depth_net, build_pose_net
from ..geometry.camera import resize_img, scale_intrinsics, view_synthesis
from ..ops.photometric import photometric_map


def normalize_image(img: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device).reshape(1, -1, 1, 1)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device).reshape(1, -1, 1, 1)
    return (img - mean) / std


@META_ARCH_REGISTRY.register()
class SupDepthModel(nn.Module):
    def __init__(self, depth_net: nn.Module, pixel_mean=(0.485, 0.456, 0.406),
                 pixel_std=(0.229, 0.224, 0.225), variance_focus: float = 0.85):
        super().__init__()
        self.depth_net = depth_net
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.variance_focus = variance_focus

    @classmethod
    def from_cfg(cls, cfg):
        return cls(
            depth_net=build_depth_net(cfg),
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            variance_focus=float(cfg.LOSS.get("VARIANCE_FOCUS", 0.85)),
        )

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        net_input = normalize_image(batch["img"], self.pixel_mean, self.pixel_std)
        depth_pred = self.depth_net(
            net_input, flip=batch.get("flip"), train=train, intrinsics=batch.get("intrinsics")
        )
        if not train:
            return {"depth_pred": depth_pred[0]}

        depth_gt = batch["depth"]
        sup_losses = []
        for pred in depth_pred:
            gt = resize_img(depth_gt, pred.shape[2:], mode="nearest")
            sup_losses.append(L.silog_loss(pred, gt, self.variance_focus))
        return {"silog_loss": sum(sup_losses) / len(sup_losses)}


@META_ARCH_REGISTRY.register()
class MonoDepth2Model(nn.Module):
    def __init__(self, depth_net: nn.Module, pose_net: nn.Module,
                 pixel_mean=(0.485, 0.456, 0.406), pixel_std=(0.229, 0.224, 0.225),
                 ssim_weight: float = 0.85, C1: float = 1e-4, C2: float = 9e-4,
                 clip_loss: float = 0.0, automask: bool = True,
                 photometric_reduce: str = "min", smooth_loss_w: float = 0.001,
                 sup_loss_w: float = 0.0, var_loss_w: float = 0.0,
                 variance_focus: float = 0.85):
        super().__init__()
        self.depth_net = depth_net
        self.pose_net = pose_net
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.ssim_weight = ssim_weight
        self.C1, self.C2 = C1, C2
        self.clip_loss = clip_loss
        self.automask = automask
        self.photometric_reduce = photometric_reduce
        self.smooth_loss_w = smooth_loss_w
        self.sup_loss_w = sup_loss_w
        self.var_loss_w = var_loss_w
        self.variance_focus = variance_focus

    @classmethod
    def from_cfg(cls, cfg):
        loss = cfg.LOSS
        return cls(
            depth_net=build_depth_net(cfg),
            pose_net=build_pose_net(cfg),
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            ssim_weight=float(loss.get("SSIM_WEIGHT", 0.85)),
            C1=float(loss.get("C1", 1e-4)),
            C2=float(loss.get("C2", 9e-4)),
            clip_loss=float(loss.get("CLIP", 0.0)),
            automask=bool(loss.get("AUTOMASK", True)),
            photometric_reduce=str(loss.get("PHOTOMETRIC_REDUCE", "min")),
            smooth_loss_w=float(loss.get("SMOOTHNESS_WEIGHT", 0.001)),
            sup_loss_w=float(loss.get("SUPERVISED_WEIGHT", 0.0)),
            var_loss_w=float(loss.get("VAR_LOSS_WEIGHT", 0.0)),
            variance_focus=float(loss.get("VARIANCE_FOCUS", 0.85)),
        )

    def _photometric_map(self, frame_A: torch.Tensor, sampled_B: torch.Tensor) -> torch.Tensor:
        """α·SSIM + (1−α)·L1 per-pixel map [G·B,1,h,w], before any clip."""
        if self.ssim_weight > 0.0:
            return photometric_map(sampled_B, frame_A, self.ssim_weight, self.C1, self.C2)
        return (sampled_B - frame_A).abs().mean(dim=1, keepdim=True)

    def _clip(self, photo: torch.Tensor, n_groups: int = 1) -> torch.Tensor:
        """The optional mean+λσ clip of a map [G·B,1,h,w]: ``n_groups``
        independent maps stacked on the leading dim (the batched per-scale
        evaluation), each clipped by its own statistics, with the unbiased
        standard deviation."""
        if self.clip_loss > 0.0:
            grouped = photo.reshape(n_groups, -1)
            cap = grouped.mean(dim=1) + self.clip_loss * grouped.std(dim=1)  # std: unbiased
            cap = cap.repeat_interleave(photo.shape[0] // n_groups).reshape(-1, 1, 1, 1)
            photo = torch.minimum(photo, cap)
        return photo

    def _scale_maps(self, resized_image: torch.Tensor, sampled: torch.Tensor,
                    resized_targets: torch.Tensor, N: int) -> torch.Tensor:
        """One scale's photometric maps [kN·B,1,h,w], clipped per group of B:
        the N warped contexts, then (automask) the N identity reprojections.

        The two halves are two calls of the map against one ``ref``: the
        identity candidates need no gradient, so autograd records no backward
        for theirs and the map's VJP runs on the N·B warped planes only (one
        map over the concatenated 2N·B candidates would compute the identity
        half's gradient and throw it away). The clip's statistics are per
        group, so concatenating the two maps before it gives the same map."""
        B = resized_image.shape[0]
        ref = resized_image.repeat(N, 1, 1, 1)
        photo = self._photometric_map(ref, sampled)
        if self.automask:
            photo = torch.cat([photo, self._photometric_map(ref, resized_targets)], dim=0)
        return self._clip(photo, n_groups=photo.shape[0] // B)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        net_input = normalize_image(batch["img"], self.pixel_mean, self.pixel_std)
        depth_pred = self.depth_net(net_input, flip=batch.get("flip"), train=train)

        if not train:
            return {"depth_pred": depth_pred[0]}

        # pose net on the (jittered) target + contexts, channel-concat
        ctx = batch["ctx_img"]  # [B,N,3,H,W]
        B, N, _, H, W = ctx.shape
        pose_input = torch.cat([batch["img"]] + [ctx[:, j] for j in range(N)], dim=1)
        poses = self.pose_net(pose_input, train=train)  # N × [B,4,4]

        image = batch["img_orig"]
        contexts_orig = batch["ctx_img_orig"]  # [B,N,3,H,W]
        intrinsics = batch["intrinsics"]

        num_scales = len(depth_pred)
        out: Dict[str, torch.Tensor] = {}
        smooth_total = 0.0
        sup_total = 0.0
        var_total = 0.0
        photo_per_scale = []

        # Per scale, all N context warps run as ONE view_synthesis on an [N·B]
        # batch, and the N warped and (automask) N identity photometric maps as
        # two maps on [N·B] each (see _scale_maps): one launch of the warp and
        # of the map's VJP per scale, two of the map.
        poses_cat = torch.cat(poses, dim=0)  # [N·B,4,4], context-major
        rot = poses_cat[:, :3, :3]
        trans = poses_cat[:, :3, 3:4]
        contexts_flat = contexts_orig.transpose(0, 1).reshape(N * B, 3, H, W)

        for i in range(num_scales):
            scale_w = 1.0 / 2 ** (num_scales - i - 1)
            h, w = depth_pred[i].shape[2:]
            resized_image = resize_img(image, (h, w))
            resized_K = scale_intrinsics(intrinsics, w / W, h / H)
            # [N·B,3,h,w]: context j occupies rows j·B:(j+1)·B, matching poses_cat
            resized_targets = resize_img(contexts_flat, (h, w)).contiguous()

            sampled, _, _, _ = view_synthesis(
                resized_targets,
                depth_pred[i].repeat(N, 1, 1, 1),
                resized_K.repeat(N, 1, 1),
                rot,
                trans,
            )

            photo = self._scale_maps(resized_image, sampled, resized_targets, N)  # [kN·B,1,h,w]
            maps = photo.reshape(-1, B, 1, h, w)

            if self.photometric_reduce == "min":
                photo_per_scale.append(maps.amin(dim=0).mean())
            elif self.photometric_reduce == "mean":
                photo_per_scale.append(maps.mean())
            else:
                raise NotImplementedError(self.photometric_reduce)

            if self.smooth_loss_w > 0.0:
                smooth_total = smooth_total + (
                    L.smoothness_loss(depth_pred[i], resized_image)
                    * scale_w * self.smooth_loss_w / num_scales
                )
            if self.sup_loss_w > 0.0:
                gt = resize_img(batch["depth"], (h, w), mode="nearest")
                sup_total = sup_total + (
                    L.silog_loss(depth_pred[i], gt, self.variance_focus)
                    * scale_w * self.sup_loss_w / num_scales
                )
            if self.var_loss_w > 0.0:
                var_total = var_total + (
                    L.variance_loss(depth_pred[i]) * scale_w * self.var_loss_w / num_scales
                )

        out["rec_loss"] = sum(photo_per_scale) / num_scales
        if self.smooth_loss_w > 0.0:
            out["smooth_loss"] = smooth_total
        if self.sup_loss_w > 0.0:
            out["sup_loss"] = sup_total
        if self.var_loss_w > 0.0:
            out["var_loss"] = var_total
        return out
