"""MotionLearning meta-architecture: unsupervised depth + dense motion (NCHW).

Counterpart of ``MotionLearningModel`` in
``simpledepthestimation_tpu/models/motion_meta_arch.py``: both frames of a pair
go through the depth net as one [2B] batch, the RGB-D pose/motion net runs on
both directions at once, and per scale one [2B] warp serves both directions of
the occlusion-masked RGB-D consistency (L1 + depth-proximity-weighted SSIM),
followed by the motion cycle consistency, motion smoothness and L0.5 sparsity
on the normalized residual motion, and the depth smoothness.

The pose net is a ``GoogleMotionNet`` (pose and a dense residual translation
field) or the rigid-only ``GooglePoseNet``: then the translation is the pose's
own, broadcast over the image, there is no motion mask, and there are no
motion smoothness and sparsity losses; the cycle loss runs on the broadcast
translations all the same. The per-step schedule of the training loop
(:func:`make_schedule_fn`) arrives in the batch: ``noise_stddev`` (the
RandLayerNorm noise ramp) and ``motion_weight`` (the motion burn-in), 0-d
tensors or floats; missing keys mean 0 and 1. The noise itself is drawn from
the ``generator`` passed with the call.

Kernels: the RGB-D warp's operand is detached (every consumer of the sampled
frame and depth either detaches it or compares it), so its warp runs the
forward kernel and the coordinate backward only; the cycle loss warps the
reverse translation field at detached coordinates, so its warp runs the
forward kernel and the image backward only.

Each direction-batched loss is the mean over [2B], i.e. the average of the two
directions; the JAX package (and the model it follows) sums the two, hence the
2× when the losses are added up.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from . import losses as L
from .build import META_ARCH_REGISTRY, build_depth_net, build_pose_net
from .meta_arch import normalize_image
from .pose_nets import GoogleMotionNet
from ..geometry.camera import resize_img, resize_img_avgpool, scale_intrinsics, view_synthesis
from ..ops.pool import max_pool


@META_ARCH_REGISTRY.register()
class MotionLearningModel(nn.Module):
    def __init__(self, depth_net: nn.Module, pose_net: nn.Module,
                 pixel_mean=(0.485, 0.456, 0.406), pixel_std=(0.229, 0.224, 0.225),
                 num_scales: int = 1, ssim_loss_w: float = 3.0, C1: float = float("inf"),
                 C2: float = 9e-6, depth_l1_loss_w: float = 0.0, smooth_loss_w: float = 0.001,
                 sup_loss_w: float = 0.0, var_loss_w: float = 0.0, variance_focus: float = 0.85,
                 motion_smooth_loss_w: float = 1.0, motion_sparsity_loss_w: float = 0.2,
                 rot_cycle_loss_w: float = 1e-3, trans_cycle_loss_w: float = 5e-2,
                 scale_normalize: bool = False, pose_use_depth: bool = True,
                 with_mask: bool = False, mask_dilation: int = 8):
        super().__init__()
        self.depth_net = depth_net
        self.pose_net = pose_net
        self.pixel_mean = tuple(pixel_mean)
        self.pixel_std = tuple(pixel_std)
        self.num_scales = num_scales
        self.ssim_loss_w = ssim_loss_w
        self.C1, self.C2 = C1, C2
        self.depth_l1_loss_w = depth_l1_loss_w
        self.smooth_loss_w = smooth_loss_w
        self.sup_loss_w = sup_loss_w
        self.var_loss_w = var_loss_w
        self.variance_focus = variance_focus
        self.motion_smooth_loss_w = motion_smooth_loss_w
        self.motion_sparsity_loss_w = motion_sparsity_loss_w
        self.rot_cycle_loss_w = rot_cycle_loss_w
        self.trans_cycle_loss_w = trans_cycle_loss_w
        self.scale_normalize = scale_normalize
        self.pose_use_depth = pose_use_depth
        self.with_mask = with_mask
        self.mask_dilation = mask_dilation

    @classmethod
    def from_cfg(cls, cfg):
        loss = cfg.LOSS

        def f(key, default):
            v = loss.get(key, default)
            return float(v) if v != "inf" else float("inf")

        return cls(
            depth_net=build_depth_net(cfg),
            pose_net=build_pose_net(cfg),
            pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
            pixel_std=tuple(cfg.MODEL.PIXEL_STD),
            num_scales=int(loss.get("NUM_SCALES", 1)),
            ssim_loss_w=f("SSIM_WEIGHT", 3.0),
            C1=f("C1", float("inf")),
            C2=f("C2", 9e-6),
            depth_l1_loss_w=f("DEPTH_L1_WEIGHT", 0.0),
            smooth_loss_w=f("SMOOTHNESS_WEIGHT", 0.001),
            sup_loss_w=f("SUPERVISED_WEIGHT", 0.0),
            var_loss_w=f("VAR_LOSS_WEIGHT", 0.0),
            variance_focus=f("VARIANCE_FOCUS", 0.85),
            motion_smooth_loss_w=f("MOTION_SMOOTHNESS_WEIGHT", 1.0),
            motion_sparsity_loss_w=f("MOTION_SPARSITY_WEIGHT", 0.2),
            rot_cycle_loss_w=f("ROT_CYCLE_WEIGHT", 1e-3),
            trans_cycle_loss_w=f("TRANS_CYCLE_WEIGHT", 5e-2),
            scale_normalize=bool(loss.get("SCALE_NORMALIZE", False)),
            pose_use_depth=bool(cfg.MODEL.POSE_NET.get("USE_DEPTH", True)),
            with_mask=bool(cfg.MODEL.get("WITH_MASK", False)),
            mask_dilation=int(cfg.MODEL.get("MASK_DILATION", 8)),
        )

    def _rgbd_consistency(self, frame_A, frame_B, depth_A, depth_B, K, R_A2B, t_A2B):
        """Occlusion-masked RGB-D photometric terms; t_A2B [B,3,H,W] dense."""
        out = {}
        # no gradient flows through the warped operand: its consumers detach
        # the sampled depth or compare it, and frame_B is an input frame
        rgbd_B = torch.cat([frame_B, depth_B], dim=1).detach()
        sampled, depth_in_B, coords, proj_mask = view_synthesis(rgbd_B, depth_A, K, R_A2B, t_A2B)
        out["coords_A_in_B"] = coords
        sampled_frame_B = sampled[:, :3]
        sampled_depth_B = sampled[:, 3:]

        proj_mask = proj_mask.float()
        occlusion_mask = (depth_in_B < sampled_depth_B).float() * proj_mask
        out["occlusion_mask"] = occlusion_mask
        normalizer = occlusion_mask.sum(dim=(1, 2, 3)) + 1.0

        if self.depth_l1_loss_w > 0:
            l1 = (sampled_depth_B.detach() - depth_in_B).abs() * occlusion_mask
            out["depth_l1_loss"] = (l1.sum(dim=(1, 2, 3)) / normalizer).mean() * self.depth_l1_loss_w

        out["rgb_l1_loss"] = ((sampled_frame_B - frame_A).abs() * occlusion_mask).mean()

        if self.ssim_loss_w > 0.0:
            depth_error = (depth_in_B - sampled_depth_B) ** 2
            second_moment = (depth_error * occlusion_mask).sum(dim=(1, 2, 3)) / normalizer + 1e-4
            second_moment = second_moment.reshape(-1, 1, 1, 1)
            proximity_weight = (second_moment / (depth_error + second_moment) * proj_mask).detach()
            ssim_map, avg_weight = L.weighted_ssim(sampled_frame_B, frame_A, proximity_weight, self.C1, self.C2)
            out["depth_proximity_weight"] = proximity_weight
            out["ssim_loss"] = (ssim_map * avg_weight).mean() * self.ssim_loss_w * 0.5
        return out

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        noise_stddev = batch.get("noise_stddev", 0.0)
        motion_weight = batch.get("motion_weight", 1.0)

        def run_depth(images, flip=None):
            return self.depth_net(images, flip=flip, train=train, noise_stddev=noise_stddev,
                                  generator=generator)

        if not train:
            net_input = normalize_image(batch["img"], self.pixel_mean, self.pixel_std)
            return {"depth_pred": run_depth(net_input, batch.get("flip"))[0]}

        frame1 = batch["img"]
        frame2 = batch["ctx_img"][:, 0]
        B = frame1.shape[0]
        flip = batch.get("flip")
        flip2 = torch.cat([flip, flip], dim=0) if flip is not None else None
        both = torch.cat([normalize_image(frame1, self.pixel_mean, self.pixel_std),
                          normalize_image(frame2, self.pixel_mean, self.pixel_std)], dim=0)
        depth_pred = run_depth(both, flip2)  # [[2B,1,H,W]]
        depth1, depth2 = depth_pred[0][:B], depth_pred[0][B:]

        pin1, pin2 = frame1, frame2
        if self.pose_use_depth:
            pin1 = torch.cat([pin1, depth1], dim=1)
            pin2 = torch.cat([pin2, depth2], dim=1)
        pose_input = torch.cat([torch.cat([pin1, pin2], dim=1), torch.cat([pin2, pin1], dim=1)], dim=0)

        if isinstance(self.pose_net, GoogleMotionNet):
            pose, motion = self.pose_net(pose_input, motion_weight=motion_weight, train=train)
        else:
            pose, motion = self.pose_net(pose_input, train=train), None
        pose_1to2, pose_2to1 = pose[:B], pose[B:]
        if motion is not None:
            motion_1to2, motion_2to1 = motion[:B], motion[B:]
        if motion is not None and self.with_mask:
            mask1 = (batch["mask"] > 0).float()
            mask2 = (batch["ctx_mask"][:, 0] > 0).float()
            if self.mask_dilation > 0:
                pool_size = self.mask_dilation * 2 + 1
                mask1 = max_pool(mask1, pool_size, 1, "SAME")
                mask2 = max_pool(mask2, pool_size, 1, "SAME")
            motion_1to2 = motion_1to2 * mask1
            motion_2to1 = motion_2to1 * mask2

        H0, W0 = depth1.shape[2:]
        losses: Dict[str, torch.Tensor] = {}

        def add(key, value):
            losses[key] = losses[key] + value if key in losses else value

        for i in reversed(range(self.num_scales)):
            scale_w = 1.0 / 2**i
            H, W = int(H0 * scale_w), int(W0 * scale_w)
            rf1 = resize_img_avgpool(frame1, (H, W))
            rf2 = resize_img_avgpool(frame2, (H, W))
            rK = scale_intrinsics(batch["intrinsics"], scale_w, scale_w)
            rd1 = resize_img_avgpool(depth1, (H, W))
            rd2 = resize_img_avgpool(depth2, (H, W))

            R_1to2, R_2to1 = pose_1to2[:, :3, :3], pose_2to1[:, :3, :3]
            if motion is not None:
                rm_1to2 = resize_img_avgpool(motion_1to2, (H, W))
                rm_2to1 = resize_img_avgpool(motion_2to1, (H, W))
                t_1to2 = pose_1to2[:, :3, 3, None, None] + rm_1to2  # [B,3,H,W]
                t_2to1 = pose_2to1[:, :3, 3, None, None] + rm_2to1
            else:
                rm_1to2 = rm_2to1 = None
                t_1to2 = pose_1to2[:, :3, 3, None, None].expand(B, 3, H, W)
                t_2to1 = pose_2to1[:, :3, 3, None, None].expand(B, 3, H, W)

            if self.scale_normalize:
                depth_mean = torch.cat([rd1, rd2], dim=0).mean()
                d1n, d2n = rd1 / depth_mean, rd2 / depth_mean
                t_1to2, t_2to1 = t_1to2 / depth_mean, t_2to1 / depth_mean
                if motion is not None:
                    rm_1to2, rm_2to1 = rm_1to2 / depth_mean, rm_2to1 / depth_mean
            else:
                d1n, d2n = rd1, rd2

            # both directions through ONE warp: first half 1→2, second half 2→1
            R_fwd = torch.cat([R_1to2, R_2to1], dim=0)
            t_fwd = torch.cat([t_1to2, t_2to1], dim=0)
            out = self._rgbd_consistency(
                torch.cat([rf1, rf2], dim=0), torch.cat([rf2, rf1], dim=0),
                torch.cat([d1n, d2n], dim=0), torch.cat([d2n, d1n], dim=0),
                torch.cat([rK, rK], dim=0), R_fwd, t_fwd,
            )
            for k, v in out.items():
                if "loss" in k:
                    add(k, 2.0 * v * scale_w)

            if self.rot_cycle_loss_w > 0 or self.trans_cycle_loss_w > 0:
                # half h pairs direction h with its reverse
                R_bwd = torch.cat([R_2to1, R_1to2], dim=0)
                t_bwd = torch.cat([t_2to1, t_1to2], dim=0)
                rot_loss, trans_loss = L.motion_consistency_loss(
                    out["coords_A_in_B"], out["occlusion_mask"], R_fwd, R_bwd, t_fwd, t_bwd)
                add("rot_loss", 2.0 * rot_loss * scale_w * self.rot_cycle_loss_w)
                add("trans_loss", 2.0 * trans_loss * scale_w * self.trans_cycle_loss_w)

            if motion is not None:
                t1_scale = (t_1to2**2).mean(dim=(1, 2, 3), keepdim=True) * 3.0
                t2_scale = (t_2to1**2).mean(dim=(1, 2, 3), keepdim=True) * 3.0
                m1n = rm_1to2 / torch.sqrt(t1_scale + 1e-12)
                m2n = rm_2to1 / torch.sqrt(t2_scale + 1e-12)
                if self.motion_smooth_loss_w > 0.0:
                    add("motion_smooth_loss", (L.motion_smoothness_loss(m1n) + L.motion_smoothness_loss(m2n))
                        * scale_w * self.motion_smooth_loss_w)
                if self.motion_sparsity_loss_w > 0.0:
                    add("motion_sparsity_loss", (L.motion_sparsity_loss(m1n) + L.motion_sparsity_loss(m2n))
                        * scale_w * self.motion_sparsity_loss_w)

            if self.sup_loss_w > 0.0:
                g1 = resize_img(batch["depth"], (H, W), mode="nearest")
                g2 = resize_img(batch["ctx_depth"][:, 0], (H, W), mode="nearest")
                add("sup_loss",
                    (L.silog_loss(rd1, g1, self.variance_focus) + L.silog_loss(rd2, g2, self.variance_focus))
                    * scale_w * self.sup_loss_w)
            if self.smooth_loss_w > 0.0:
                add("smooth_loss",
                    (L.smoothness_loss(d1n, rf1) + L.smoothness_loss(d2n, rf2)) * scale_w * self.smooth_loss_w)
            if self.var_loss_w > 0.0:
                add("var_loss", (L.variance_loss(rd1) + L.variance_loss(rd2)) * scale_w * self.var_loss_w)
        return losses


def make_schedule_fn(cfg) -> Callable[[int], Dict[str, float]]:
    """Per-step scalars of the MotionLearning recipe, as a function of the
    number of updates already applied (``step``, from 0): the step trains under
    ``global_step = step + 1``, with the RandLayerNorm noise
    ``NOISE_STDDEV·min(global_step/RAMPUP_ITERS, 1)²`` (0 without a ramp) and
    the motion burn-in weight ``clip(2·global_step/BURN_IN_ITERS − 1, 0, 1)``
    (1 without burn-in). The port's own copy of the JAX project's
    ``projects/MotionLearning/train.py`` schedule; hand it to
    ``parallel.make_train_step(..., schedule_fn=)``."""
    noise_stddev = float(cfg.MODEL.DEPTH_NET.get("NOISE_STDDEV", 0.0))
    rampup = int(cfg.MODEL.DEPTH_NET.get("RAMPUP_ITERS", 0))
    burn_in = int(cfg.MODEL.POSE_NET.get("BURN_IN_ITERS", 0))

    def schedule(step: int) -> Dict[str, float]:
        global_step = step + 1
        stddev = noise_stddev * min(global_step / float(rampup), 1.0) ** 2 if rampup > 0 else 0.0
        weight = float(np.clip(2.0 * global_step / burn_in - 1.0, 0.0, 1.0)) if burn_in > 0 else 1.0
        return {"noise_stddev": float(np.float32(stddev)), "motion_weight": float(np.float32(weight))}

    return schedule
