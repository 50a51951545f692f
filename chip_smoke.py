#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels under ``simpledepthestimation_tpu_torch/csrc`` from
source (nvcc, sm_90a), holds each against its plain PyTorch version on the
card, drives the port's main paths with bfloat16 convolutions (MonoDepth2-R18
at B=16, 192x640, N=2: depth prediction, the validation-loss pass and the train
step; MotionLearning-R18 at B=16, 128x416: the train step with the noise ramp
and the motion burn-in at their ends; both again through their training entry
points, loader, checkpoints and evaluation included; the Supervised family at
B=16, 352x704: DepthResNet-18 and BTS-R50 train steps, BTS with its frozen
parameters and with ``TPU.REMAT`` off and on, and BTS through its entry point;
PackNet01-1A on the MonoDepth2 step at B=8, 192x640, with ``TPU.REMAT`` off
and on; the rigid MotionLearning step, GoogleResNetv2 + GooglePoseNet, at B=16,
128x416) and compares forward, gradients and one update of each model with a
CPU copy at a small shape. Every phase
prints one JSON line; a failed phase raises, so the exit code is non-zero and
the closing line is not printed. Without a CUDA device it exits non-zero at
once: nothing here falls back to the CPU.

Both models are the shipped ``projects/{MonoDepth2,MotionLearning}/configs/resnet18.yaml``
as they stand (encoder ``"18pt"``): each train phase prints one ``warm_start``
line with the weight file the ImageNet warm start found (``null``: none in
reach, the encoder keeps its seeded weights, and the port's warning about it
goes to standard error).

Phases: device, environment (the Python, Pillow with its libjpeg-turbo, and
OpenCV or ``null``), build, kernels, main_path, train_path, motion_train_path,
cli_train_path and motion_cli_train_path (the training entry points
``projects/{MonoDepth2,MotionLearning}/train_torch.py`` run in this process at
B=16 on synthetic data: two epochs with checkpoints and evaluations,
``--resume`` to a third, ``--eval``; their training log goes to standard
error), default_trainer_path (``tools/train_net_torch.py``: ``DefaultTrainer`` with
its hooks on MonoDepth2-R18 at B=16 192x640, two epochs, PreciseBN over 2 batches
at each epoch's end, a ``torch.profiler`` trace of one iteration, ``--eval``),
async_vis_path (``projects/MonoDepth2/train_torch.py`` with ``TEST.ASYNC`` and
``VIS_PERIOD 2``: epoch 0's asynchronous evaluation equal to a synchronous one of
its checkpoint, the panels; the loop's step time with ``TEST.ASYNC`` off and on),
waymo_cli_train_path, waymo_motion_cli_train_path and waymo_supervised_cli_train_path
(``projects/{MonoDepth2,MotionLearning,Supervised}/train_torch.py`` on their
``resnet18_waymo.yaml`` as shipped, on one fabricated tree of 2 segments x 40
1280x1920 JPEG frames with sparse depth and masks: two epochs, one, one; each
evaluated on four frames, then ``--eval``), jpeg_agreement (the port's JPEG
reader against ``cv2.imread`` on the tree's frames, where OpenCV imports),
predictor_export_path (``DefaultPredictor`` on 375x1242 frames, ``export_inference``
and ``load_exported`` against eager, ``tools/demo_torch.py`` on two PNG frames),
supervised_train_path and bts_train_path (``projects/Supervised/configs/
{resnet18,bts_r50}.yaml`` as shipped; neither launches K1–K5, checked),
supervised_cli_train_path (``projects/Supervised/train_torch.py`` as the two
above, with ``bts_r50.yaml``'s model), packnet_train_path (``packnet_1a.yaml``
as shipped), motion_rigid_train_path (MotionLearning's ``resnet18.yaml`` with
GoogleResNetv2 and GooglePoseNet; a ResNet-18 weight file in reach, which the
warm start of a net without a torchvision encoder must leave unread),
report_tools_path (``tools/{bench_models,profile_step,trace_step,bench_loader}_torch.py``
through their functions: every family's train-step images/s under the bench's
protocol, the five MonoDepth2 step variants, the flagship's profiler table beside
the device busy time of the same step, the loader on OpenCV-written frames;
launches a step checked for each), cpu_agreement (float32, then ``cpu_agreement_bf16``: the loss pass and depth in
bfloat16 against the CPU copy), cpu_agreement_train_step, cpu_agreement_motion_train_step,
cpu_agreement_bts, cpu_agreement_packnet (1A and 1B, bf16; its train step, and its
gradient with cuDNN off), cpu_agreement_motion_rigid_train_step, multiprocess_path
(two processes of this script, ``--multiprocess-rank``, on the one card in a gloo group:
MonoDepth2-R18 at 192x640, global B=8, three steps, and one MotionLearning-R18 step with the
RandLayerNorm noise on, against the same global batches at world 1; launches and collectives a
step, each rank's step time), nccl_world1_path (an NCCL group of world 1: the Supervised entry
point and the same MonoDepth2 steps through the global path against the runs with no group, and
multiprocess_path's world 2 against them) (and,
with ``--profile``, a torch.profiler breakdown of the forward calls and of the
train steps by kernel, PackNet's convolutions and GroupNorms by shape). Then one
line ``{"kernels": [...]}`` with one entry per kernel
at the main path's largest shape, the card's name and power limit as nvidia-smi
prints them, and the closing line ``{"ok": true, "device": {...}}``. With
``--kernels-only`` it stops after the kernels phase, without the closing line
(copied into the root of another checkout, it times that checkout's kernels).

Kernel times (``measure``): ``ms`` = CUDA events over 10 back-to-back calls
after a warm-up, ``device_ms`` = the device time per call of the kernels those
calls launched (torch.profiler), ``enqueue_us`` = host time per call of 100
calls with no wait inside; the same three for the library call. ``bound_ms``
is the least time the card could take: the larger of (bytes the function must
move: each input read once, each output written once) / 3.35e12 B/s and
(float32 operations outside the tensor cores) / 67e12 flop/s — the published
peaks of one H100 SXM at its full power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

F32_TOL = 1e-5  # kernel vs plain version, float32: same formula, other summation order
BF16_WARP_TOL = 2.0**-7  # one bfloat16 ulp below 2.0: both round a float32 result to bfloat16
AGREE_RTOL = 1e-4  # card (kernels, cuDNN float32) vs CPU (plain versions) on one set of weights
# Backward kernels, relative to the largest value of the plain version's result.
# K3 sums C products in float32 in another order than the plain version: 1e-5.
# K4: the window variances cancel (second moments near 0.3, variances down to
# 1e-3) and are then divided by denominators d1*d2 that come down to C2 = 9e-4
# and enter squared, so a last-bit difference of a window sum (1e-7) is amplified
# a hundredfold on either side: 1e-4 (1.7e-5 measured at the largest shape).
# bfloat16 operands convert to float32 exactly on both sides and K3 returns
# float32, so its limit stays; K4's wrapper rounds the float32 gradient to the
# inputs' bfloat16, one ulp = 2^-7 of the value.
BWD_RTOL = 1e-5
VJP_RTOL = 1e-4
# K5 adds with float32 atomics in an order that changes from run to run, and a pixel that many
# output pixels land on (an image corner under clamped coordinates: thousands) sums that many
# terms: the JAX package's limit for its own kernel (atol 2e-5, rtol 1e-5), with the relative
# part taken of the sum of the terms' sizes, since signed cotangents cancel in the sum
K5_ATOL, K5_RTOL = 2e-5, 1e-5
BF16_VJP_RTOL = 2.0**-7
# Parameter gradients, card vs CPU, per tensor relative to its largest entry: a whole backward
# pass in another order, and a bias or norm gradient is a sum of thousands of signed terms that
# cancel (worst measured: 1.4e-3 at the encoder's bn1.bias, while the global norm agreed to 1.2e-5)
GRAD_AGREE_RTOL = 5e-3
GRAD_NORM_RTOL = 1e-4
# The bfloat16 loss pass, card vs CPU copy, relative: both round the same operands to bfloat16 at
# the same places, but cuDNN and the CPU's convolutions sum in other orders and each rounds its
# result to bfloat16 (a relative step of up to 2^-7), through some twenty convolutions of the two
# nets; depth_pred per pixel, its largest, mean and median error. Where both sides round at the
# same places most pixels leave the last convolution and its sigmoid on the same bfloat16 value,
# so the median is one float32 rounding at most; a cast at another place moves every pixel.
# Measured on the card (NVIDIA H100 80GB HBM3, 700 W): losses 1.5e-4, depth 1.16e-2, mean 1.2e-3,
# median 0; limits about 3x that, the median's 1e-5
BF16_AGREE_LOSS_RTOL = 5e-4
BF16_AGREE_DEPTH_RTOL, BF16_AGREE_DEPTH_MEAN_RTOL, BF16_AGREE_DEPTH_MEDIAN_RTOL = 3e-2, 3e-3, 1e-5
BF16_AGREE_REASON = ("bfloat16 convolutions summed in another order on each side, each result rounded to "
                     "bfloat16 (2^-7 relative) through ~20 convolutions; limits about 3x the errors measured "
                     "on the card (losses 1.5e-4, depth per pixel 1.16e-2, mean 1.2e-3); the median 1e-5: "
                     "most pixels on the same bfloat16 value where both round at the same places (measured 0)")
TRAIN_FIXED_STEPS, TRAIN_FRESH_STEPS = 8, 3
TIMED_STEPS = 10  # steady state: train steps back to back, one wait at the end

# The pose net's first convolution has 16 channels and feeds a GroupNorm of 16 groups, which
# subtracts each channel's mean: the bias's gradient is zero but for rounding, and may be 0.0.
ZERO_GRADIENT_BY_CONSTRUCTION = {"pose_net.conv1.0.bias"}

PLANES = [(192, 640), (96, 320), (48, 160), (24, 80)]
# projects/MonoDepth2/configs/Base_waymo.yaml: Resize 192x480 and its three lower scales, where the
# warp's 8x32 tiles are ragged (240, 120 and 60 pixels a row)
WAYMO_PLANES = [(192, 480), (96, 240), (48, 120), (24, 60)]
SMOKE_B, SMOKE_N = 16, 2
MOTION_HW = (128, 416)  # projects/MotionLearning/configs/Base.yaml: Resize IMG_H, IMG_W


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_warm_start(model: str, cfg, state, pretrained: bool = True) -> None:
    """One line per model: its encoder name and the weight file its warm start
    found (``None``: the encoder keeps its seeded weights; the port's logger
    says so on standard error at each state made). ``pretrained``: whether the
    shipped config names an ImageNet-pretrained encoder (PackNet's names none)."""
    from simpledepthestimation_tpu_torch.models.pretrained import BTS_CONVERTIBLE

    name = str(cfg.MODEL.DEPTH_NET.get("ENCODER_NAME", ""))
    emit({"phase": "warm_start", "model": model, "encoder_name": name, "weights_file": state.pretrained_weights})
    if pretrained != (name.endswith("pt") or name in BTS_CONVERTIBLE):
        raise AssertionError(f"the shipped config names {'no' if pretrained else 'an'} ImageNet-pretrained "
                             f"encoder: {name!r}")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stdout}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


ENQUEUE_CALLS = 100


def measure(fn, iters: int = 10) -> dict:
    """Three times of one call of ``fn``, which launches work on the card:

    - ``ms``: CUDA events around ``iters`` back-to-back calls (``cuda_ms``). Below
      about 0.04 ms this is the host's enqueue cost, not the device's time;
    - ``device_ms``: the device time per call of every kernel the calls launched,
      from torch.profiler's kernel rows over ``iters`` calls (``device_kernels``
      names them, with their launch counts and device ms per call);
    - ``enqueue_us``: host wall time per call of ``ENQUEUE_CALLS`` calls with no
      wait inside (the clock stops before the one synchronize at the end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ms = cuda_ms(fn, iters)
    for _ in range(3):  # now and then a profile records no kernel time at all: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum(r[2] for r in rows) > 0:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ENQUEUE_CALLS):
        fn()
    enqueue_us = (time.perf_counter() - t0) * 1e6 / ENQUEUE_CALLS
    torch.cuda.synchronize()
    return {"ms": ms, "device_ms": sum(r[2] for r in rows) / iters, "enqueue_us": enqueue_us,
            "device_kernels": [[k[:60], c, ms / iters] for k, c, ms in rows]}


def measure_into(rec: dict, fn, prefix: str = "") -> None:
    """``measure(fn)`` into ``rec``; with ``prefix="library_"`` the keys become
    ``library_ms``, ``library_device_ms``, ``library_enqueue_us``, ..."""
    rec.update({prefix + k: v for k, v in measure(fn).items()})


def warp_bound(B, C, h, w, elem_bytes):
    nbytes = B * h * w * (8 + 2 * elem_bytes * C)
    flops = B * h * w * (10 + 11 * C)
    return _bound(nbytes, flops)


def photo_bound(B, C, H, W, elem_bytes):
    nbytes = B * H * W * (2 * elem_bytes * C + 4)
    flops = B * H * W * C * 100
    return _bound(nbytes, flops)


def warp_bwd_bound(B, C, h, w, elem_bytes):
    nbytes = B * h * w * (8 + 8 + 2 * elem_bytes * C)  # x, y in; dx, dy out; image and ct per channel
    flops = B * h * w * (10 + 17 * C)
    return _bound(nbytes, flops)


def warp_bwd_image_bound(B, C, h, w, Hi, Wi, elem_bytes):
    nbytes = B * h * w * (8 + elem_bytes * C) + B * C * Hi * Wi * 4  # x, y, ct in; float32 d_img out
    flops = B * h * w * (10 + 8 * C)
    return _bound(nbytes, flops)


def photo_bwd_bound(B, C, H, W, elem_bytes, n_out):
    nbytes = B * H * W * (2 * elem_bytes * C + 4 + 4 * C * n_out)  # a, b, g in; float32 gradients out
    flops = B * H * W * C * 200
    return _bound(nbytes, flops)


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smooth_field(rng, B, H, W, cell=8):
    """Low-frequency random images in [0,1): a coarse random grid, one value
    per ``cell`` pixels, interpolated bilinearly. [B,3,H,W] float32."""
    import numpy as np

    low = rng.rand(B, 3, H // cell + 2, W // cell + 2)
    ys, xs = np.arange(H) / cell, np.arange(W) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    rows0, rows1 = low[:, :, y0], low[:, :, y0 + 1]
    top = rows0[..., x0] * (1 - fx) + rows0[..., x0 + 1] * fx
    bot = rows1[..., x0] * (1 - fx) + rows1[..., x0 + 1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def make_batch(seed: int, B: int, H: int, W: int, N: int, device, smooth: bool = False):
    """A training batch from a numpy seed, NCHW, on ``device``.

    ``smooth=False``: white-noise frames (on these the identity reprojection
    beats every warp, so the automask cuts the warp off from the loss: fine for
    a forward). ``smooth=True``: low-frequency frames whose contexts are the
    target shifted sideways by a few pixels plus a little noise, so warped and
    identity maps each win the minimum somewhere and every parameter of both
    nets gets a gradient: the batches of the train path."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    if smooth:
        img = smooth_field(rng, B, H, W)
        shifts = [(-1) ** j * (2 + j // 2) for j in range(N)]
        ctx = np.stack([np.roll(img, sh, axis=3) for sh in shifts], axis=1)
        ctx = (ctx + 0.01 * rng.rand(B, N, 3, H, W)).astype(np.float32)
    else:
        img = rng.rand(B, 3, H, W).astype(np.float32)
        ctx = (0.7 * img[:, None] + 0.3 * rng.rand(B, N, 3, H, W)).astype(np.float32)
    K = np.tile(
        np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1)
    )
    batch = {
        "img": img, "img_orig": img, "ctx_img": ctx, "ctx_img_orig": ctx, "intrinsics": K,
        "flip": rng.rand(B) < 0.5,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def synthesis_coords(seed: int, B: int, h: int, w: int, device, smooth_depth: bool = False):
    """Pixel coordinates of a real view synthesis: seeded depth and pose.

    The depth is white noise in [0.5, 30.5) per pixel (neighbouring pixels land up
    to a few hundred pixels apart: the gathers scatter over the whole plane) or,
    with ``smooth_depth``, a coarse random grid (one value per 16 pixels)
    interpolated bilinearly, as a depth net's upsampled output is smooth
    (neighbouring pixels land next to each other)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from simpledepthestimation_tpu_torch.geometry.camera import view_synthesis
    from simpledepthestimation_tpu_torch.geometry.pose import pose_vec2mat

    rng = np.random.RandomState(seed)
    if smooth_depth:
        low = torch.from_numpy(rng.rand(B, 1, h // 16 + 2, w // 16 + 2).astype(np.float32)).to(device)
        depth = 0.5 + 30.0 * F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    else:
        depth = torch.from_numpy((0.5 + 30.0 * rng.rand(B, 1, h, w)).astype(np.float32)).to(device)
    vec = np.concatenate([0.3 * rng.randn(B, 3), 0.02 * rng.randn(B, 3)], 1).astype(np.float32)
    T = pose_vec2mat(torch.from_numpy(vec).to(device))
    K = torch.tensor(
        [[0.58 * w, 0, w / 2], [0, 1.92 * h, h / 2], [0, 0, 1]], device=device
    ).repeat(B, 1, 1)
    image = torch.from_numpy(rng.rand(B, 3, h, w).astype(np.float32)).to(device)
    _, _, norm, _ = view_synthesis(image, depth, K, T[:, :3, :3], T[:, :3, 3:4])
    x = ((norm[..., 0] + 1.0) * (w - 1) / 2.0).contiguous()
    y = ((norm[..., 1] + 1.0) * (h - 1) / 2.0).contiguous()
    return image, x, y


def _check_warp(image, x, y, tol, label, timed: bool):
    import torch
    import torch.nn.functional as F

    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_plain

    before = warp_bilinear.launches
    out = warp_bilinear(image, x, y)
    torch.cuda.synchronize()
    ref = warp_bilinear_plain(image, x, y)
    err = (out.float() - ref.float()).abs().max().item()
    B, C, H, W = image.shape
    h, w = x.shape[1:]
    bound_ms, bound_by = warp_bound(B, C, h, w, image.element_size())
    rec = {
        "kernel": "warp_bilinear_fwd", "case": label, "shape": [B, C, h, w],
        "dtype": str(image.dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if timed:
        grid = torch.stack([2.0 * x / (W - 1.0) - 1.0, 2.0 * y / (H - 1.0) - 1.0], dim=-1).to(image.dtype)
        measure_into(rec, lambda: warp_bilinear(image, x, y))
        rec["plain_ms"] = cuda_ms(lambda: warp_bilinear_plain(image, x, y), iters=3, warmup=1)
        measure_into(rec, lambda: F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                                                align_corners=True), "library_")
    rec["launches"] = warp_bilinear.launches - before
    emit(rec)
    if not (err <= tol):
        raise AssertionError(f"warp_bilinear_fwd disagrees with its plain version: {rec}")
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"warp_bilinear_fwd gave non-finite values: {rec}")
    return rec


def _check_photo(a, b, tol, label, timed: bool):
    import torch

    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map, photometric_map_plain

    before = photometric_map.launches
    out = photometric_map(a, b, 0.85, 1e-4, 9e-4)
    torch.cuda.synchronize()
    ref = photometric_map_plain(a, b, 0.85, 1e-4, 9e-4)
    err = (out - ref).abs().max().item()
    B, C, H, W = a.shape
    bound_ms, bound_by = photo_bound(B, C, H, W, a.element_size())
    rec = {
        "kernel": "photometric_map_fwd", "case": label, "shape": [B, C, H, W],
        "dtype": str(a.dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    if timed:
        measure_into(rec, lambda: photometric_map(a, b, 0.85, 1e-4, 9e-4))
        rec["plain_ms"] = cuda_ms(lambda: photometric_map_plain(a, b, 0.85, 1e-4, 9e-4), iters=3, warmup=1)
    rec["launches"] = photometric_map.launches - before
    emit(rec)
    if not (err <= tol):
        raise AssertionError(f"photometric_map_fwd disagrees with its plain version: {rec}")
    if out.shape != (B, 1, H, W) or not torch.isfinite(out).all():
        raise AssertionError(f"photometric_map_fwd gave a wrong shape or non-finite values: {rec}")
    return rec


def _check_warp_bwd(image, x, y, ct, tol, label, timed: bool):
    """K3 through the autograd Function (forward kernel, then backward kernel)
    against the plain version; timed through its wrapper alone."""
    import torch
    import torch.nn.functional as F

    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear, warp_coord_grad, warp_coord_grad_plain

    before = warp_bilinear.bwd_launches
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    dx, dy = torch.autograd.grad(warp_bilinear(image, xg, yg), (xg, yg), ct)
    torch.cuda.synchronize()
    rx, ry = warp_coord_grad_plain(image, x, y, ct)
    scale = max(rx.abs().max().item(), ry.abs().max().item(), 1e-30)
    err = max((dx - rx).abs().max().item(), (dy - ry).abs().max().item())
    B, C, H, W = image.shape
    h, w = x.shape[1:]
    bound_ms, bound_by = warp_bwd_bound(B, C, h, w, image.element_size())
    rec = {
        "kernel": "warp_bilinear_bwd_coords", "case": label, "shape": [B, C, h, w],
        "dtype": str(image.dtype).replace("torch.", ""), "max_abs_err": err, "ref_max": scale,
        "tol": tol * scale, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if timed:
        measure_into(rec, lambda: warp_coord_grad(image, x, y, ct))
        rec["plain_ms"] = cuda_ms(lambda: warp_coord_grad_plain(image, x, y, ct), iters=3, warmup=1)
        # one PyTorch call for the same function: grid_sample's backward with respect
        # to the grid (its gradient is per unit of normalised coordinate: a constant
        # factor (W-1)/2, (H-1)/2 away, which costs nothing next to the call)
        grid = torch.stack([2.0 * x / (W - 1.0) - 1.0, 2.0 * y / (H - 1.0) - 1.0], dim=-1)
        grid = grid.to(image.dtype).requires_grad_()
        sampled = F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        measure_into(rec, lambda: torch.autograd.grad(sampled, grid, ct, retain_graph=True), "library_")
    rec["launches"] = warp_bilinear.bwd_launches - before
    emit(rec)
    if not (err <= tol * scale):
        raise AssertionError(f"warp_bilinear_bwd_coords disagrees with its plain version: {rec}")
    if dx.shape != x.shape or dx.dtype != torch.float32 or not (torch.isfinite(dx).all() and torch.isfinite(dy).all()):
        raise AssertionError(f"warp_bilinear_bwd_coords gave a wrong shape, dtype or non-finite values: {rec}")
    return rec


def corner_add_counts(x, y, C, Hi, Wi):
    """The float adds the image cotangent of a warp at ``x, y`` [B,h,w] into C
    planes of ``Hi x Wi`` needs (the corners of non-zero weight inside the image,
    times C), and the most of them on one address of one plane and channel."""
    import torch

    B = x.shape[0]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0, y0 = x0.clamp(-2, Wi).long(), y0.clamp(-2, Hi).long()
    plane = torch.arange(B, device=x.device)[:, None, None] * (Hi * Wi)
    counts = torch.zeros(B * Hi * Wi, dtype=torch.int64, device=x.device)
    for dx, dy, w in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)), (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        ix, iy = x0 + dx, y0 + dy
        adds = (ix >= 0) & (ix < Wi) & (iy >= 0) & (iy < Hi) & (w != 0)
        counts += torch.bincount((plane + iy.clamp(0, Hi - 1) * Wi + ix.clamp(0, Wi - 1))[adds], minlength=B * Hi * Wi)
    return int(counts.sum()) * C, int(counts.max())


def _check_warp_bwd_image(x, y, ct, Hi, Wi, label, timed: bool):
    """K5 through the autograd Function (forward kernel, then the image
    backward kernel, coordinates detached) against the plain version, to
    ``atol + rtol·|ref|`` per value; timed through its wrapper alone."""
    import torch

    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear, warp_image_grad, warp_image_grad_plain

    before = warp_bilinear.bwd_image_launches
    B, C, h, w = ct.shape
    image = torch.zeros((B, C, Hi, Wi), device=ct.device, dtype=ct.dtype).requires_grad_()
    (got,) = torch.autograd.grad(warp_bilinear(image, x, y), image, ct)
    torch.cuda.synchronize()
    ref = warp_image_grad_plain(x, y, ct.float(), Hi, Wi)
    # a sum in another order errs in proportion to the sum of its terms' sizes (the
    # scatter of |ct|), not to the sum itself, which signed terms cancel; the Function
    # also rounds the float32 result to the image's type once
    scale = warp_image_grad_plain(x, y, ct.float().abs(), Hi, Wi)
    excess = ((got.float() - ref).abs() - K5_RTOL * scale).max().item()
    if ct.dtype == torch.bfloat16:
        excess = ((got.float() - ref).abs() - K5_RTOL * scale - BF16_WARP_TOL / 2 * ref.abs()).max().item()
    err = (got.float() - ref).abs().max().item()
    bound_ms, bound_by = warp_bwd_image_bound(B, C, h, w, Hi, Wi, ct.element_size())
    on_border = ((x == 0) | (x == Wi - 1) | (y == 0) | (y == Hi - 1)).float().mean().item()
    corner_adds, most_on_one = corner_add_counts(x, y, C, Hi, Wi)
    rec = {
        "kernel": "warp_bilinear_bwd_image", "case": label, "shape": [B, C, h, w], "image_hw": [Hi, Wi],
        "dtype": str(ct.dtype).replace("torch.", ""), "max_abs_err": err, "ref_max": ref.abs().max().item(),
        "tol": f"{K5_ATOL} + {K5_RTOL}*scatter(|ct|)" + (" + 2^-8*|ref|" if ct.dtype == torch.bfloat16 else ""),
        "scatter_abs_ct_max": scale.max().item(), "share_on_border": on_border, "corner_adds": corner_adds,
        "most_adds_on_one_address": most_on_one, "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if timed:
        measure_into(rec, lambda: warp_image_grad(x, y, ct, Hi, Wi))
        rec["plain_ms"] = cuda_ms(lambda: warp_image_grad_plain(x, y, ct, Hi, Wi), iters=3, warmup=1)
        # one PyTorch call for the same function: grid_sample's backward with respect to its input
        grid = torch.stack([2.0 * x / (Wi - 1.0) - 1.0, 2.0 * y / (Hi - 1.0) - 1.0], dim=-1).to(ct.dtype)
        zeros = torch.zeros((B, C, Hi, Wi), device=ct.device, dtype=ct.dtype)
        measure_into(rec, lambda: torch.ops.aten.grid_sampler_2d_backward(
            ct, zeros, grid, 0, 0, True, [True, False]), "library_")
    rec["launches"] = warp_bilinear.bwd_image_launches - before
    emit(rec)
    if not (excess <= K5_ATOL):
        raise AssertionError(f"warp_bilinear_bwd_image disagrees with its plain version: {rec}")
    if got.shape != (B, C, Hi, Wi) or got.dtype != ct.dtype or not torch.isfinite(got.float()).all():
        raise AssertionError(f"warp_bilinear_bwd_image gave a wrong shape, dtype or non-finite values: {rec}")
    return rec


def _check_photo_bwd(a, b, g, tol, label, timed: bool, both: bool):
    """K4 through the autograd Function against the plain version, for the
    gradient of ``a`` alone (the main path: ``b`` is the constant target frame)
    or of both inputs; timed through its wrapper alone."""
    import torch

    from simpledepthestimation_tpu_torch.ops.photometric import (
        photometric_map, photometric_vjp, photometric_vjp_plain,
    )

    before = photometric_map.bwd_launches
    ag = a.clone().requires_grad_()
    bg = b.clone().requires_grad_(both)
    wanted = (ag, bg) if both else (ag,)
    grads = torch.autograd.grad(photometric_map(ag, bg, 0.85, 1e-4, 9e-4), wanted, g)
    torch.cuda.synchronize()
    refs = photometric_vjp_plain(a, b, g, 0.85, 1e-4, 9e-4)[: len(grads)]
    scale = max(max(r.float().abs().max().item() for r in refs), 1e-30)
    err = max((k.float() - r.float()).abs().max().item() for k, r in zip(grads, refs))
    B, C, H, W = a.shape
    bound_ms, bound_by = photo_bwd_bound(B, C, H, W, a.element_size(), len(grads))
    rec = {
        "kernel": "photometric_map_bwd", "case": label + ("_ga_gb" if both else "_ga"), "shape": [B, C, H, W],
        "dtype": str(a.dtype).replace("torch.", ""), "max_abs_err": err, "ref_max": scale,
        "tol": tol * scale, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    if timed:
        measure_into(rec, lambda: photometric_vjp(a, b, g, 0.85, 1e-4, 9e-4, need_a=True, need_b=both))
        rec["plain_ms"] = cuda_ms(lambda: photometric_vjp_plain(a, b, g, 0.85, 1e-4, 9e-4), iters=3, warmup=1)
    rec["launches"] = photometric_map.bwd_launches - before
    emit(rec)
    if not (err <= tol * scale):
        raise AssertionError(f"photometric_map_bwd disagrees with its plain version: {rec}")
    if any(k.shape != a.shape or k.dtype != a.dtype or not torch.isfinite(k.float()).all() for k in grads):
        raise AssertionError(f"photometric_map_bwd gave a wrong shape, dtype or non-finite values: {rec}")
    return rec


def _check_kernel_chain(image, x, y, target, weight):
    """All four kernels end to end: the gradient of a weighted sum of
    photometric_map(warp_bilinear(image, x, y), target) in x and y through the
    two autograd Functions, against autograd of the plain composition."""
    import torch

    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map, photometric_map_plain
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_plain

    # the L1 term |a − b| has a kink where the warped frame meets the target; there a
    # last-bit difference between a kernel and its plain version flips the sign of the
    # gradient (by 2·(1−α)/C·weight·∂a/∂x), so the target is moved off near-ties
    target = torch.where((warp_bilinear_plain(image, x, y) - target).abs() < 1e-4, target + 1e-3, target)

    def grads(warp, photo):
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        loss = (photo(warp(image, xg, yg), target, 0.85, 1e-4, 9e-4) * weight).sum()
        return torch.autograd.grad(loss, (xg, yg))

    dx, dy = grads(warp_bilinear, photometric_map)
    torch.cuda.synchronize()
    rx, ry = grads(warp_bilinear_plain, photometric_map_plain)
    scale = max(rx.abs().max().item(), ry.abs().max().item())
    err = max((dx - rx).abs().max().item(), (dy - ry).abs().max().item())
    # K4's limit: its cancellation dominates, K3 adds a three-term sum to it
    rec = {"kernel": "chain_K1_K2_K4_K3", "shape": list(image.shape), "max_abs_err": err, "ref_max": scale,
           "tol": VJP_RTOL * scale}
    emit(rec)
    if not (scale > 0 and err <= VJP_RTOL * scale):
        raise AssertionError(f"the kernels' chained gradient disagrees with autograd of the plain versions: {rec}")


def host_path_costs(device, calls: int = 2000) -> dict:
    """Host time per call (µs, ``calls`` calls, no wait inside) of the steps of
    K1's host path at the smallest MonoDepth2 plane, where the host's cost is the
    whole of a call's time: the library lookup, the stream handle (as a
    ``torch.cuda.Stream`` and raw), the output allocation (two ways), the bare
    ctypes launch, the whole wrapper, and ``F.grid_sample`` beside it. The
    wrapper's checks are what the whole call costs beyond its steps."""
    import torch
    import torch.nn.functional as F

    from simpledepthestimation_tpu_torch.ops import cuda_lib
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    B, C, h, w = 2 * SMOKE_B, 3, *PLANES[-1]
    image = torch.rand(B, C, h, w, device=device)
    x, y = torch.rand(B, h, w, device=device) * w, torch.rand(B, h, w, device=device) * h
    grid = torch.stack([2.0 * x / (w - 1.0) - 1.0, 2.0 * y / (h - 1.0) - 1.0], dim=-1)
    out = torch.empty_like(image)
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream().cuda_stream
    # the C entry point gained the device index before the stream; an older tree's has none
    args = (image.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(), B, C, h, w, h, w, 0,
            *((device.index or 0,) if len(lib.sde_warp_bilinear_fwd.argtypes) == 13 else ()), stream)

    def per_call_us(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        return us

    costs = {
        "cuda_lib_load": per_call_us(cuda_lib.load),
        "current_stream_object": per_call_us(lambda: torch.cuda.current_stream().cuda_stream),
        "raw_stream_handle": per_call_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "torch_empty_output": per_call_us(lambda: torch.empty((B, C, h, w), dtype=image.dtype, device=image.device)),
        "new_empty_output": per_call_us(lambda: image.new_empty((B, C, h, w))),
        "ctypes_launch_alone": per_call_us(lambda: lib.sde_warp_bilinear_fwd(*args)),
        "warp_bilinear_whole": per_call_us(lambda: warp_bilinear(image, x, y)),
        "grid_sample_whole": per_call_us(lambda: F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                                                               align_corners=True)),
    }
    emit({"kernel": "warp_bilinear_fwd", "case": "host_path_costs_us", "shape": [B, C, h, w], "calls": calls, **costs})
    return costs


def phase_kernels(device):
    import numpy as np
    import torch

    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map, photometric_vjp

    def record(rec):
        if rec["dtype"] == "float32":
            worst[rec["kernel"]] = max(worst.get(rec["kernel"], 0.0), rec["max_abs_err"])
        return rec

    def check_warp(*args, **kw):
        return record(_check_warp(*args, **kw))

    def check_photo(*args, **kw):
        return record(_check_photo(*args, **kw))

    def check_warp_bwd(*args, **kw):
        return record(_check_warp_bwd(*args, **kw))

    def check_photo_bwd(*args, **kw):
        return record(_check_photo_bwd(*args, **kw))

    def check_warp_bwd_image(*args, **kw):
        return record(_check_warp_bwd_image(*args, **kw))

    rng = np.random.RandomState(7)
    flagship = {}
    worst = {}  # largest float32 error per kernel over every case

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device)

    NB = SMOKE_N * SMOKE_B  # the main path warps all contexts of a batch at once
    # float32 operands, then the same cases with bfloat16 operands. Warp in
    # bfloat16: kernel and plain version both compute in float32 and round the
    # result to bfloat16 once; their float32 results differ in the last bits, so
    # the rounded ones may differ by one bfloat16 ulp (2^-7 for values in [1,2),
    # less below). Photometric map: bfloat16 inputs convert to float32 exactly
    # and the output is float32, so the float32 limit holds for both types.
    # The backward kernels return float32 computed from operands that convert to
    # float32 exactly, so K3 keeps its float32 limit for bfloat16 operands; K4's
    # wrapper rounds the gradient to the inputs' type (see BF16_VJP_RTOL).
    for dtype, warp_tol, vjp_tol, tag in ((torch.float32, F32_TOL, VJP_RTOL, ""),
                                          (torch.bfloat16, BF16_WARP_TOL, BF16_VJP_RTOL, "_bf16")):
        for h, w in PLANES:
            image, x, y = synthesis_coords(11 + h, NB, h, w, device)
            image = image.to(dtype)
            ct = (rand(NB, 3, h, w) - 0.5).to(dtype)
            rec = check_warp(image, x, y, warp_tol, "view_synthesis" + tag, timed=True)
            rec_bwd = check_warp_bwd(image, x, y, ct, BWD_RTOL, "view_synthesis" + tag, timed=True)
            if (h, w) == PLANES[0] and dtype == torch.float32:
                flagship["warp"], flagship["warp_bwd"] = rec, rec_bwd
            if (h, w) == PLANES[0]:
                image_s, xs, ys = synthesis_coords(13 + h, NB, h, w, device, smooth_depth=True)
                check_warp(image_s.to(dtype), xs, ys, warp_tol, "view_synthesis_smooth_depth" + tag, timed=True)
                check_warp_bwd(image_s.to(dtype), xs, ys, ct, BWD_RTOL, "view_synthesis_smooth_depth" + tag, timed=True)
            # uniform coordinates reaching one whole plane outside on every side
            xu = (rand(NB, h, w) * 3.0 - 1.0) * w
            yu = (rand(NB, h, w) * 3.0 - 1.0) * h
            check_warp(image, xu, yu, warp_tol, "uniform_3x_plane" + tag, timed=True)
            check_warp_bwd(image, xu, yu, ct, BWD_RTOL, "uniform_3x_plane" + tag, timed=True)
        for h, w in WAYMO_PLANES:
            image, x, y = synthesis_coords(17 + h, NB, h, w, device)
            image = image.to(dtype)
            ct = (rand(NB, 3, h, w) - 0.5).to(dtype)
            check_warp(image, x, y, warp_tol, "waymo_view_synthesis" + tag, timed=True)
            check_warp_bwd(image, x, y, ct, BWD_RTOL, "waymo_view_synthesis" + tag, timed=True)
        for C, (oh, ow), label in ((3, (37, 83), "unaligned"), (5, (21, 45), "unaligned_other_output_size")):
            image = rand(2, C, 37, 83).to(dtype)
            x, y = rand(2, oh, ow) * 100 - 8, rand(2, oh, ow) * 50 - 6
            check_warp(image, x, y, warp_tol, label + tag, timed=False)
            # an expanded (stride-0) cotangent, as a mean's backward hands over
            ct = (rand(2, C, 1, 1) - 0.5).to(dtype).expand(2, C, oh, ow)
            check_warp_bwd(image, x, y, ct, BWD_RTOL, label + tag, timed=False)
        # the forward's edge cases: rows whose width is not a multiple of 4 and planes of
        # an odd number of pixels (no 16-byte row access lines up), each channel count
        # from 1 to 5, output planes of another size than the image's, exact edges
        for C in (1, 2, 3, 4, 5):
            for (ih, iw), (oh, ow) in (((37, 83), (37, 83)), ((21, 46), (21, 46)), ((37, 83), (19, 45)),
                                       ((16, 64), (16, 64))):
                image = rand(3, C, ih, iw).to(dtype)
                x, y = rand(3, oh, ow) * (iw + 4) - 2, rand(3, oh, ow) * (ih + 4) - 2
                x[0, :3], y[1, :, :3] = iw - 1.0, ih - 1.0
                check_warp(image, x, y, warp_tol, f"edge_C{C}_{ih}x{iw}_to_{oh}x{ow}" + tag, timed=False)

        # the map of the N·B warped candidates against the target (the main path since the
        # identity candidates got their own call: [32,...]) and the [2N·B,...] stack of
        # warped and identity candidates in one call, as the main path ran it before
        for h, w in PLANES:
            for planes, label in ((NB, "main_path"), (2 * NB, "flagship")):
                a, b = rand(planes, 3, h, w), rand(planes, 3, h, w)
                b = 0.8 * a + 0.2 * b  # correlated, as a warped frame is with its target
                g = rand(planes, 1, h, w)
                rec = check_photo(a.to(dtype), b.to(dtype), F32_TOL, label + tag, timed=True)
                rec_bwd = check_photo_bwd(a.to(dtype), b.to(dtype), g, vjp_tol, label + tag, timed=True, both=False)
                if planes == 2 * NB:
                    check_photo_bwd(a.to(dtype), b.to(dtype), g, vjp_tol, label + tag, timed=True, both=True)
                elif (h, w) == PLANES[0] and dtype == torch.float32:
                    flagship["photo"], flagship["photo_bwd"] = rec, rec_bwd
        for shape, label, timed in (((2, 3, 37, 83), "unaligned", False), ((1, 2, 2, 2), "smallest", False),
                                    ((2, 3, 3, 3), "three", False), ((1, 1, 2, 5), "two_by_five", False),
                                    ((1, 3, 768, 1920), "large_plane", True)):
            a, b = rand(*shape).to(dtype), rand(*shape).to(dtype)
            check_photo(a, b, F32_TOL, label + tag, timed=timed)
            g = rand(shape[0], 1, 1, 1).expand(shape[0], 1, *shape[2:])  # expanded, as above
            check_photo_bwd(a, b, g, vjp_tol, label + tag, timed=timed, both=True)
        # a tie: a == b gives exactly zero gradient (the clip is at 0, sign(0) = 0)
        a = rand(2, 3, 37, 83).to(dtype)
        ties = photometric_vjp(a, a.clone(), rand(2, 1, 37, 83), 0.85, 1e-4, 9e-4)
        nonzero = sum(int(torch.count_nonzero(t)) for t in ties)
        emit({"kernel": "photometric_map_bwd", "case": "tie_a_equals_b" + tag, "shape": [2, 3, 37, 83],
              "nonzero_gradients": nonzero})
        if nonzero:
            raise AssertionError(f"photometric_map_bwd gave {nonzero} non-zero gradients at a == b")

    # K5 at the MotionLearning step's shape: the cycle loss warps the [2B,3,H,W] reverse
    # translation field at the RGB-D warp's coordinates, which view synthesis clamps to the
    # image, so every pixel that projects out of view lands on the border row or column
    NM, (mh, mw) = 2 * SMOKE_B, MOTION_HW
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        _, x, y = synthesis_coords(23, NM, mh, mw, device)
        ct = (rand(NM, 3, mh, mw) - 0.5).to(dtype)
        rec = check_warp_bwd_image(x, y, ct, mh, mw, "view_synthesis" + tag, timed=True)
        if dtype == torch.float32:
            flagship["warp_bwd_image"] = rec
        _, xs, ys = synthesis_coords(25, NM, mh, mw, device, smooth_depth=True)
        check_warp_bwd_image(xs, ys, ct, mh, mw, "view_synthesis_smooth_depth" + tag, timed=True)
        # a near-identity warp, as the MotionLearning step at its start makes: every pixel
        # moved by under 1.5 px (a smooth random field), clamped to the image
        field = torch.from_numpy(smooth_field(rng, NM, mh, mw)[:, :2]).to(device)
        cols = torch.arange(mw, device=device, dtype=torch.float32).expand(NM, mh, mw)
        rows = torch.arange(mh, device=device, dtype=torch.float32)[:, None].expand(NM, mh, mw)
        xn = (cols + 3.0 * (field[:, 0] - 0.5)).clamp(0, mw - 1.0).contiguous()
        yn = (rows + 3.0 * (field[:, 1] - 0.5)).clamp(0, mh - 1.0).contiguous()
        check_warp_bwd_image(xn, yn, ct, mh, mw, "near_identity" + tag, timed=True)
        # no pixel on the border: uniform inside the plane, every corner adds (the most atomics)
        xi, yi = 1.0 + rand(NM, mh, mw) * (mw - 3.0), 1.0 + rand(NM, mh, mw) * (mh - 3.0)
        check_warp_bwd_image(xi, yi, ct, mh, mw, "interior" + tag, timed=True)
        xu = (rand(NM, mh, mw) * 3.0 - 1.0) * mw
        yu = (rand(NM, mh, mw) * 3.0 - 1.0) * mh
        check_warp_bwd_image(xu, yu, ct, mh, mw, "uniform_3x_plane" + tag, timed=True)
        # the same, clamped as view synthesis clamps: 8/9 of the pixels on the border
        check_warp_bwd_image(xu.clamp(0, mw - 1.0).contiguous(), yu.clamp(0, mh - 1.0).contiguous(), ct, mh, mw,
                             "border_clamped" + tag, timed=True)
        # every pixel of a plane at one point: all lanes of every warp on the same four addresses
        xc = torch.full((NM, mh, mw), mw * 0.37 + 0.25, device=device)
        yc = torch.full((NM, mh, mw), mh * 0.61 + 0.5, device=device)
        check_warp_bwd_image(xc, yc, ct, mh, mw, "one_address" + tag, timed=True)
        for (Hi, Wi), (oh, ow), label in (((44, 300), (52, 300), "unaligned_other_image_height"),
                                          ((37, 83), (21, 45), "unaligned_other_output_size")):
            x, y = rand(2, oh, ow) * (Wi + 6) - 3, rand(2, oh, ow) * (Hi + 6) - 3
            check_warp_bwd_image(x, y, (rand(2, 3, oh, ow) - 0.5).to(dtype), Hi, Wi, label + tag, timed=False)

    # K1 and K3 at the MotionLearning step's shapes: the RGB-D warp of frame and depth
    # ([2B,4,H,W], depth in metres) and the cycle loss's warp of the [2B,3,H,W] reverse
    # translation field at the same coordinates. The warp's limit is one rounding of the
    # result, so it scales with the largest value (the depth's). Before the next case, the
    # only one that builds a model, so that --kernels-only times every K3 case of an older tree
    for dtype, warp_tol, tag in ((torch.float32, F32_TOL, ""), (torch.bfloat16, BF16_WARP_TOL, "_bf16")):
        image, x, y = synthesis_coords(29, NM, mh, mw, device)
        rgbd = torch.cat([image, 0.5 + 30.0 * rand(NM, 1, mh, mw)], dim=1).to(dtype)
        rgbd_tol = warp_tol * max(1.0, rgbd.float().abs().max().item())
        check_warp(rgbd, x, y, rgbd_tol, "motion_rgbd" + tag, timed=True)
        check_warp_bwd(rgbd, x, y, (rand(NM, 4, mh, mw) - 0.5).to(dtype), BWD_RTOL, "motion_rgbd" + tag, timed=True)
        check_warp(image.to(dtype), x, y, warp_tol, "motion_cycle" + tag, timed=True)

    # K5 on the inputs of its launch in a MotionLearning train step (the main path's own)
    x, y, ct, Hi, Wi = motion_step_image_grad_inputs(device)
    check_warp_bwd_image(x, y, ct, Hi, Wi, "motion_step", timed=True)

    # all four kernels in a row, at the second plane
    h, w = PLANES[1]
    image, x, y = synthesis_coords(5, 4, h, w, device)
    _check_kernel_chain(image, x, y, 0.8 * image + 0.2 * rand(4, 3, h, w), rand(4, 1, h, w))
    host_path_costs(device)
    # K2 at a tie: a == b gives a map of exactly zero (the ratio's numerator d - n is 0, and
    # |a - b| is 0), on the small planes' 16-row tiles and the main path's 32-row ones; last,
    # so that a tree whose kernel fails it has its other cases timed first
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        for shape in ((2, 3, 37, 83), (NB, 3, *PLANES[0])):
            a = rand(*shape).to(dtype)
            before = photometric_map.launches
            nonzero = int(torch.count_nonzero(photometric_map(a, a.clone(), 0.85, 1e-4, 9e-4)))
            emit({"kernel": "photometric_map_fwd", "case": "tie_a_equals_b" + tag, "shape": list(shape),
                  "nonzero_map_values": nonzero, "launches": photometric_map.launches - before})
            if nonzero:
                raise AssertionError(f"photometric_map_fwd gave {nonzero} non-zero values at a == b")
    for rec in flagship.values():
        rec["max_abs_err"] = worst[rec["kernel"]]
    return flagship


def smoke_cfg(extra=()):
    from simpledepthestimation_tpu_torch.config import get_cfg

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(root, "projects", "MonoDepth2", "configs", "resnet18.yaml"))
    cfg.merge_from_list(list(extra))
    return cfg


def reset_launch_counts() -> None:
    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    warp_bilinear.launches = warp_bilinear.bwd_launches = warp_bilinear.bwd_image_launches = 0
    photometric_map.launches = photometric_map.bwd_launches = 0


def read_launch_counts() -> dict:
    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    return {
        "warp_bilinear_fwd": warp_bilinear.launches, "photometric_map_fwd": photometric_map.launches,
        "warp_bilinear_bwd_coords": warp_bilinear.bwd_launches, "photometric_map_bwd": photometric_map.bwd_launches,
        "warp_bilinear_bwd_image": warp_bilinear.bwd_image_launches,
    }


def phase_main_path(device):
    import torch

    from simpledepthestimation_tpu_torch.models import build_model
    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    cfg = smoke_cfg()
    B, (H, W), N = int(cfg.SOLVER.IMS_PER_BATCH), PLANES[0], int(cfg.MODEL.POSE_NET.NUM_CONTEXTS)
    if (B, N) != (SMOKE_B, SMOKE_N):
        raise AssertionError(f"config gives B={B}, N={N}; the kernel phase assumed {SMOKE_B}, {SMOKE_N}")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))  # device: the card
    batches = [make_batch(100 + i, B, H, W, N, device) for i in range(3)]

    def timed(fn):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(stop)

    steps = []
    reset_launch_counts()
    for batch in batches:
        k1, k2 = warp_bilinear.launches, photometric_map.launches
        with torch.no_grad():
            pred, eval_ms = timed(lambda: model(batch, train=False))
        depth = pred["depth_pred"]
        if (warp_bilinear.launches, photometric_map.launches) != (k1, k2):
            raise AssertionError("the train=False forward launched a warp or photometric kernel")
        if depth.shape != (B, 1, H, W) or depth.dtype != torch.float32:
            raise AssertionError(f"depth_pred has shape {tuple(depth.shape)}, dtype {depth.dtype}")
        lo, hi = depth.min().item(), depth.max().item()
        # depth = 1 / (1/80 + (10 - 1/80) * softplus(.)): at most 80, and above 0.1 only
        # while the softplus disparity stays below 1, which random weights do not promise
        if not (torch.isfinite(depth).all() and lo > 0.0 and hi <= 80.0 * (1 + 1e-6)):
            raise AssertionError(f"depth_pred outside (0, 80]: min {lo}, max {hi}")
        with torch.no_grad():
            losses, train_ms = timed(lambda: model(batch, train=True))
        d1, d2 = warp_bilinear.launches - k1, photometric_map.launches - k2
        # per scale one warp and two maps (the warped candidates, then the identity ones)
        if (d1, d2) != (4, 8):
            raise AssertionError(f"train=True forward launched K1 {d1}x and K2 {d2}x, expected 4 and 8")
        vals = {k: v.item() for k, v in losses.items()}
        if set(vals) != {"rec_loss", "smooth_loss"} or not all(v == v and abs(v) < 1e6 for v in vals.values()):
            raise AssertionError(f"loss dict is wrong or not finite: {vals}")
        steps.append({"depth_min": lo, "depth_max": hi, "eval_ms": eval_ms, "loss_pass_ms": train_ms, **vals})
    launches = read_launch_counts()
    if launches["warp_bilinear_bwd_coords"] or launches["photometric_map_bwd"] or launches["warp_bilinear_bwd_image"]:
        raise AssertionError(f"a forward under no_grad launched a backward kernel: {launches}")
    emit({
        "phase": "main_path", "model": "MonoDepth2-R18", "batch": B, "hw": [H, W], "contexts": N,
        "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "steps": steps, "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches


def _drive_train_step(state, step, batches, timed_batches, expected, metric_keys, nonzero_grads=None,
                      exempt=frozenset()):
    """Drive ``step`` once per batch of ``batches``, each step timed alone on CUDA
    events, then ``TIMED_STEPS`` steps back to back over ``timed_batches``, the way a
    training loop runs them, with one wait at the end.

    Checked: each step's kernel launches (``expected``: name -> (least, most)),
    metrics that are 0-d tensors on the card with the keys ``metric_keys``, finite,
    with a positive ``grad_norm``; after the first step a finite gradient for every
    parameter, non-zero for ``nonzero_grads`` (None: every parameter but
    ``exempt``); and every parameter but ``exempt`` moved. Returns the per-step
    records, the launches of the checked steps and the steady ms per step."""
    import torch

    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    reset_launch_counts()
    records, metrics_dev = [], []
    for i, batch in enumerate(batches):
        counts = read_launch_counts()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(batch)
        stop.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3  # the step returns without waiting for the card
        torch.cuda.synchronize()
        per_step = {k: v - counts[k] for k, v in read_launch_counts().items()}
        if any(not lo <= per_step[k] <= hi for k, (lo, hi) in expected.items()):
            raise AssertionError(f"train step {i} launched {per_step}, expected (least, most) {expected}")
        if not all(isinstance(v, torch.Tensor) and v.device.type == "cuda" and v.dim() == 0 for v in metrics.values()):
            raise AssertionError("the step's metrics are not 0-d tensors on the card")
        if i == 0:
            grads = {k: p.grad for k, p in state.model.named_parameters()}
            bad = [k for k, g in grads.items() if g is None or not torch.isfinite(g).all()]
            if bad:
                raise AssertionError(f"{len(bad)} gradients missing or not finite, e.g. {bad[:5]}")
            names = [k for k in grads if k not in exempt] if nonzero_grads is None else nonzero_grads
            zero = [k for k in names if not bool((grads[k] != 0).any())]
            if zero:
                raise AssertionError(f"{len(zero)} parameters received a zero gradient, e.g. {zero[:5]}")
        metrics_dev.append(metrics)
        records.append({"step_ms": start.elapsed_time(stop), "enqueue_ms": enqueue_ms})
    launches = read_launch_counts()
    for rec, metrics in zip(records, metrics_dev):
        rec.update({k: v.item() for k, v in metrics.items()})
        if set(metrics) != set(metric_keys):
            raise AssertionError(f"unexpected metrics {sorted(metrics)}")
        if not all(v == v and abs(v) < 1e6 for k, v in rec.items() if isinstance(v, float)):
            raise AssertionError(f"a metric is not finite: {rec}")
        if not rec["grad_norm"] > 0:
            raise AssertionError(f"grad_norm is not positive: {rec}")
    unchanged = [k for k, p in state.model.named_parameters() if torch.equal(p.detach(), before[k]) and k not in exempt]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} parameters did not change, e.g. {unchanged[:5]}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        step(timed_batches[i % len(timed_batches)])
    torch.cuda.synchronize()
    return records, launches, (time.perf_counter() - t0) * 1e3 / TIMED_STEPS


def phase_train_path(device):
    """The train step through the port's entry points, full width, on the card."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step

    cfg = smoke_cfg()
    B, (H, W), N = int(cfg.SOLVER.IMS_PER_BATCH), PLANES[0], int(cfg.MODEL.POSE_NET.NUM_CONTEXTS)
    steps_per_epoch = 4  # so that the rate drops at step 60 = LR_STEPS 15 epochs: not reached here
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=steps_per_epoch)
    emit_warm_start("MonoDepth2-R18", cfg, state)
    if next(state.model.parameters()).device.type != "cuda":
        raise AssertionError("create_train_state did not place the model on the card")
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP))
    fixed = make_batch(300, B, H, W, N, device, smooth=True)
    fresh = [make_batch(301 + i, B, H, W, N, device, smooth=True) for i in range(TRAIN_FRESH_STEPS)]

    # per step and scale one launch of K1, K3 and K4 (the VJP of the warped candidates' map
    # only) and two of K2 (the warped and the identity candidates' maps); no K5
    per_step = {"warp_bilinear_fwd": 4, "photometric_map_fwd": 8, "warp_bilinear_bwd_coords": 4,
                "photometric_map_bwd": 4}
    expected = {**{k: (n, n) for k, n in per_step.items()}, "warp_bilinear_bwd_image": (0, 0)}
    records, launches, steady_ms = _drive_train_step(
        state, step, [fixed] * TRAIN_FIXED_STEPS + fresh, fresh, expected,
        {"total_loss", "grad_norm", "rec_loss", "smooth_loss"}, exempt=ZERO_GRADIENT_BY_CONSTRUCTION)
    for i, rec in enumerate(records):
        rec["batch"] = "fixed" if i < TRAIN_FIXED_STEPS else "fresh"
    first, last = records[0]["total_loss"], records[TRAIN_FIXED_STEPS - 1]["total_loss"]
    if not last < first:
        raise AssertionError(f"total_loss on the fixed batch did not fall: step 1 {first}, step {TRAIN_FIXED_STEPS} {last}")
    n_steps = TRAIN_FIXED_STEPS + TRAIN_FRESH_STEPS + TIMED_STEPS
    lrs = state.scheduler.get_last_lr()
    if state.step != n_steps or state.scheduler.last_step != n_steps or lrs != [float(cfg.SOLVER.DEPTH_LR), float(cfg.SOLVER.POSE_LR)]:
        raise AssertionError(f"step count or rate is off: step {state.step}, lr {lrs}")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("a parameter left float32")

    depth = make_eval_step(state)(fixed)
    lo, hi = depth.min().item(), depth.max().item()
    if depth.shape != (B, 1, H, W) or not (torch.isfinite(depth).all() and lo > 0.0 and hi <= 80.0 * (1 + 1e-6)):
        raise AssertionError(f"depth_pred after training is off: shape {tuple(depth.shape)}, min {lo}, max {hi}")
    emit({
        "phase": "train_path", "model": "MonoDepth2-R18", "batch": B, "hw": [H, W], "contexts": N,
        "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "optimizer": str(cfg.SOLVER.OPT), "lr": lrs,
        "steps": records, "launches": launches, "launches_per_step": per_step,
        "steady_step_ms": steady_ms, "steady_images_per_s": B / steady_ms * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "depth_after": [lo, hi],
    })
    return launches


def motion_cfg(extra=()):
    from simpledepthestimation_tpu_torch.config import get_cfg

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(root, "projects", "MotionLearning", "configs", "resnet18.yaml"))
    cfg.merge_from_list(list(extra))
    return cfg


def make_motion_batch(seed: int, B: int, H: int, W: int, device):
    """A MotionLearning batch (a frame and one context) from a numpy seed, NCHW:
    smooth frames, the context the frame shifted sideways by two pixels plus a
    little noise."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    img = smooth_field(rng, B, H, W)
    ctx = (np.roll(img, 2, axis=3)[:, None] + 0.01 * rng.rand(B, 1, 3, H, W)).astype(np.float32)
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    batch = {"img": img, "ctx_img": ctx, "intrinsics": K, "flip": rng.rand(B) < 0.5}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


# the end of the noise ramp and of the motion burn-in: the RandLayerNorm noise, the motion
# net and the cycle loss all run
MOTION_SCHEDULE = {"noise_stddev": 0.5, "motion_weight": 1.0}
MOTION_LOSSES = {"rgb_l1_loss", "ssim_loss", "rot_loss", "trans_loss", "motion_smooth_loss",
                 "motion_sparsity_loss", "smooth_loss"}
MOTION_CHECKED_STEPS = 5


def motion_step_image_grad_inputs(device):
    """The inputs of K5's launch in one MotionLearning train step at full width
    (seeded random weights, B=16 pairs, 128x416, the schedule at its ends):
    ``x, y, ct`` and the image's ``H, W``, as the cycle loss hands them over."""
    import torch

    from simpledepthestimation_tpu_torch.ops import warp as warp_ops
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    cfg = motion_cfg()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP), schedule_fn=lambda i: MOTION_SCHEDULE)
    captured = []
    launch = warp_ops.warp_image_grad

    def capture(x, y, ct, H, W):
        captured.append((x.clone(), y.clone(), ct.contiguous().clone(), H, W))
        return launch(x, y, ct, H, W)

    warp_ops.warp_image_grad = capture  # the warp's backward looks it up when it runs
    try:
        step(make_motion_batch(400, SMOKE_B, *MOTION_HW, device))
    finally:
        warp_ops.warp_image_grad = launch
    if len(captured) != 1:
        raise AssertionError(f"a MotionLearning step launched K5 {len(captured)} times, expected 1")
    return captured[0]


def phase_motion_train_path(device):
    """The MotionLearning train step through the port's entry points, full width, on the card."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step

    cfg = motion_cfg()
    B, (H, W) = int(cfg.SOLVER.IMS_PER_BATCH), MOTION_HW
    if B != SMOKE_B:
        raise AssertionError(f"config gives B={B}; the kernel phase assumed {SMOKE_B}")
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    emit_warm_start("MotionLearning-R18", cfg, state)
    if next(state.model.parameters()).device.type != "cuda" or state.noise_generator.device.type != "cuda":
        raise AssertionError("create_train_state did not place the model and its noise generator on the card")
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP), schedule_fn=lambda i: MOTION_SCHEDULE)
    batches = [make_motion_batch(400 + i, B, H, W, device) for i in range(MOTION_CHECKED_STEPS)]

    # the RGB-D warp (K1, K3 for its coordinates) and the cycle loss's warp (K1, K5 for its image)
    expected = {"warp_bilinear_fwd": (2, 1 << 30), "warp_bilinear_bwd_coords": (1, 1),
                "warp_bilinear_bwd_image": (1, 1)}
    records, launches, steady_ms = _drive_train_step(
        state, step, batches, batches, expected, MOTION_LOSSES | {"total_loss", "grad_norm"},
        nonzero_grads=("depth_net.encoder.encoder.conv1.weight", "pose_net.refiner0.conv3.weight",
                       "pose_net.trans_scale"))

    depth = make_eval_step(state)(batches[0])
    lo, hi = depth.min().item(), depth.max().item()
    if depth.shape != (B, 1, H, W) or not (torch.isfinite(depth).all() and lo > 0.0):
        raise AssertionError(f"depth_pred after training is off: shape {tuple(depth.shape)}, min {lo}, max {hi}")
    emit({
        "phase": "motion_train_path", "model": "MotionLearning-R18 (GoogleResNet-18 randLN + GoogleMotionNet)",
        "batch": B, "hw": [H, W], "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "optimizer": str(cfg.SOLVER.OPT),
        "schedule": MOTION_SCHEDULE, "steps": records, "launches": launches,
        "launches_per_step": {k: v // MOTION_CHECKED_STEPS for k, v in launches.items()},
        "steady_step_ms": steady_ms, "steady_pairs_per_s": B / steady_ms * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "depth_after": [lo, hi],
    })
    return launches


CLI_EPOCHS, CLI_TRAIN_LENGTH, CLI_TEST_LENGTH = 2, 96, 8  # 6 steps an epoch at B=16
CLI_EVAL_KEYS = ("abs_rel", "sq_rel", "rms", "log_rms", "d1", "d2", "d3")


def _cli(project: str, argv):
    """``simple_main`` of ``projects/<project>/train_torch.py`` in this process,
    as its command line would run it with ``argv``; returns what it returns.
    The port's console log goes to standard error (its handler is made here)."""
    import contextlib
    import importlib.util

    from simpledepthestimation_tpu_torch.engine import default_argument_parser, simple_main

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "projects", project, "train_torch.py")
    spec = importlib.util.spec_from_file_location(f"train_torch_{project}", path)
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    with contextlib.redirect_stdout(sys.stderr):
        return simple_main(default_argument_parser().parse_args([str(a) for a in argv]), entry.train, entry.test)


def _metric_rows(run_dir):
    with open(os.path.join(run_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def _check_cli_rows(rows, iterations, n_eval, label):
    """Step rows for exactly ``iterations``, every loss finite; ``n_eval`` rows
    with the 7 KITTI metrics, finite. Returns the eval rows."""
    import math

    steps = [r for r in rows if "total_loss" in r]
    if [r["iteration"] for r in steps] != list(iterations):
        raise AssertionError(f"{label}: step rows for iterations {[r['iteration'] for r in steps]}, "
                             f"expected {list(iterations)}")
    bad = [r for r in steps if not all(math.isfinite(v) for k, v in r.items() if "loss" in k)]
    if bad:
        raise AssertionError(f"{label}: a logged loss is not finite: {bad[0]}")
    evals = [r for r in rows if "kitti evaluator/abs_rel" in r]
    if len(evals) != n_eval or not all(
            math.isfinite(r[f"kitti evaluator/{k}"]) for r in evals for k in CLI_EVAL_KEYS):
        raise AssertionError(f"{label}: expected {n_eval} evaluation rows with 7 finite metrics, got {evals}")
    return evals


def _loader_alone_s(argv) -> float:
    """Seconds a batch of the train loader that ``argv`` configures takes with
    nothing else running (one epoch, page-locked as in training)."""
    from simpledepthestimation_tpu_torch.data import build_train_loader
    from simpledepthestimation_tpu_torch.engine import assemble_cfg, default_argument_parser

    cfg = assemble_cfg(default_argument_parser().parse_args([str(a) for a in argv]))
    # the seed do_train gives the loader (a negative SEED, as the shipped configs have it, means 0)
    loader = build_train_loader(cfg, seed=cfg.SEED if cfg.SEED >= 0 else 0, pin_memory=True)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) / n


def _cli_train_path(phase, project, model_name, hw, per_step, absent,
                    model_overrides=("MODEL.DEPTH_NET.ENCODER_NAME", "18pt")):
    """Train, resume and evaluate through ``projects/<project>/train_torch.py`` at
    B=16 on the synthetic dataset, bf16 as shipped: two epochs
    of 6 steps with a checkpoint and an evaluation after each, then ``--resume``
    to a third epoch, then ``--eval``. ``model_overrides`` turn the yaml's model
    into the shipped one (and may set ``LOG_PERIOD`` 1: a row for every step). Checked: finite losses in every
    ``metrics.json`` row, the checkpoints, the evaluation rows, that the resumed
    run trained the third epoch only, that ``--eval`` gives the last evaluation
    row exactly, and the launches of the path's kernels (``per_step``: name ->
    exact count a step, or None for at least one; ``absent``: never)."""
    import shutil
    import tempfile

    import torch

    h, w = hw
    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="sde_cli_")
    try:
        argv = ["--cfg", os.path.join(root, "projects", project, "configs", "synthetic_quick.yaml"),
                *model_overrides, "SOLVER.IMS_PER_BATCH", SMOKE_B,
                "DATASETS.TRAIN.IMG_HEIGHT", h, "DATASETS.TRAIN.IMG_WIDTH", w,
                "DATASETS.TEST.IMG_HEIGHT", h, "DATASETS.TEST.IMG_WIDTH", w,
                "DATASETS.TRAIN.LENGTH", CLI_TRAIN_LENGTH, "DATASETS.TEST.LENGTH", CLI_TEST_LENGTH,
                "SOLVER.MAX_EPOCHS", CLI_EPOCHS, "SOLVER.CHECKPOINT_PERIOD", 1, "TEST.EVAL_PERIOD", 1,
                "OUTPUT_DIR", out]
        run_dir = os.path.join(out, f"{project}_synthetic_quick")
        steps_per_epoch = CLI_TRAIN_LENGTH // SMOKE_B
        loader_s = _loader_alone_s(argv)

        reset_launch_counts()
        t0 = time.perf_counter()
        state = _cli(project, argv)
        train_s = time.perf_counter() - t0
        if next(state.model.parameters()).device.type != "cuda":
            raise AssertionError(f"{phase}: the model did not train on the card")
        del state
        rows = _metric_rows(run_dir)
        first_steps = [r for r in rows if "total_loss" in r]
        evals = _check_cli_rows(rows, range(CLI_EPOCHS * steps_per_epoch), CLI_EPOCHS, phase)
        ckpts = sorted(f for f in os.listdir(run_dir) if f.startswith("model_"))
        if ckpts != [f"model_{e:04d}.pth" for e in range(CLI_EPOCHS)]:
            raise AssertionError(f"{phase}: checkpoints {ckpts}")

        t0 = time.perf_counter()
        _cli(project, ["--resume"] + argv + ["SOLVER.MAX_EPOCHS", CLI_EPOCHS + 1])
        resume_s = time.perf_counter() - t0
        launches = read_launch_counts()
        more = _metric_rows(run_dir)[len(rows):]
        resumed = _check_cli_rows(more, range(CLI_EPOCHS * steps_per_epoch, (CLI_EPOCHS + 1) * steps_per_epoch),
                                  1, f"{phase} --resume")
        if not os.path.isfile(os.path.join(run_dir, f"model_{CLI_EPOCHS:04d}.pth")):
            raise AssertionError(f"{phase}: --resume saved no checkpoint of epoch {CLI_EPOCHS}")

        t0 = time.perf_counter()
        results = _cli(project, ["--eval"] + argv)
        eval_s = time.perf_counter() - t0
        got = {k: results["kitti evaluator"][k] for k in CLI_EVAL_KEYS}
        want = {k: resumed[-1][f"kitti evaluator/{k}"] for k in CLI_EVAL_KEYS}
        if got != want:
            raise AssertionError(f"{phase}: --eval gave {got}, the last evaluation row of training {want}")

        n_steps = (CLI_EPOCHS + 1) * steps_per_epoch
        for name, n in per_step.items():
            if (launches[name] < 1) if n is None else (launches[name] != n * n_steps):
                raise AssertionError(f"{phase}: {name} launched {launches[name]} times in {n_steps} steps, "
                                     f"expected {'at least 1' if n is None else n * n_steps}")
        if any(launches[name] for name in absent):
            raise AssertionError(f"{phase}: a kernel the path does not run was launched: {launches}")
        torch.cuda.empty_cache()
        emit({
            "phase": phase, "model": model_name, "entry_point": f"projects/{project}/train_torch.py",
            "batch": SMOKE_B, "hw": [h, w], "train_samples": CLI_TRAIN_LENGTH, "test_samples": CLI_TEST_LENGTH,
            "epochs": CLI_EPOCHS, "steps": n_steps, "launches": launches, "checkpoints": ckpts,
            "median_step_wall_s": _median([r["time"] for r in first_steps]),
            "median_data_time_s": _median([r["data_time"] for r in first_steps]),
            "median_h2d_copy_s": _median([r["h2d_time"] for r in first_steps if "h2d_time" in r]),
            "loader_alone_batch_s": loader_s,
            "train_run_s": train_s, "resume_run_s": resume_s, "eval_run_s": eval_s,
            "eval": {k: evals[-1][f"kitti evaluator/{k}"] for k in CLI_EVAL_KEYS},
            "eval_after_resume": got,
        })
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_cli_train_path(device):
    return _cli_train_path(
        "cli_train_path", "MonoDepth2", "MonoDepth2-R18", PLANES[0],
        {"warp_bilinear_fwd": 4, "photometric_map_fwd": 8, "warp_bilinear_bwd_coords": 4, "photometric_map_bwd": 4},
        absent=("warp_bilinear_bwd_image",))


def phase_motion_cli_train_path(device):
    return _cli_train_path(
        "motion_cli_train_path", "MotionLearning", "MotionLearning-R18 (GoogleResNet-18 randLN + GoogleMotionNet)",
        MOTION_HW, {"warp_bilinear_fwd": None, "warp_bilinear_bwd_coords": None, "warp_bilinear_bwd_image": None},
        absent=("photometric_map_fwd", "photometric_map_bwd"))


# --- the hook-driven trainer, the asynchronous evaluation and the panels, inference and export ---

MONO_PER_STEP = {"warp_bilinear_fwd": 4, "photometric_map_fwd": 8, "warp_bilinear_bwd_coords": 4,
                 "photometric_map_bwd": 4, "warp_bilinear_bwd_image": 0}
# a PreciseBN forward computes the MonoDepth2 loss without its backward: a validation-loss pass
PRECISE_BN_PER_BATCH = {"warp_bilinear_fwd": 4, "photometric_map_fwd": 8, "warp_bilinear_bwd_coords": 0,
                        "photometric_map_bwd": 0, "warp_bilinear_bwd_image": 0}
PRECISE_BN_ITERS = 2
PROFILE_ITER = 3
VIS_PERIOD = 2
EXPORT_RTOL = 1e-6  # exported program against eager on the card: largest |Δ| over the largest depth
PREDICTOR_FRAME = (375, 1242)  # a KITTI raw frame


def _tool(name: str):
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch_tool", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mono_cli_argv(out: str, extra=()):
    """``projects/MonoDepth2/configs/synthetic_quick.yaml`` overridden to the shipped
    model and batch (``18pt``, B=16, 192x640, bf16 as the yaml has it): two epochs
    of 6 steps, a checkpoint and an evaluation each, a row for every step."""
    h, w = PLANES[0]
    root = os.path.dirname(os.path.abspath(__file__))
    return ["--cfg", os.path.join(root, "projects", "MonoDepth2", "configs", "synthetic_quick.yaml"),
            "MODEL.DEPTH_NET.ENCODER_NAME", "18pt", "SOLVER.IMS_PER_BATCH", SMOKE_B,
            "DATASETS.TRAIN.IMG_HEIGHT", h, "DATASETS.TRAIN.IMG_WIDTH", w,
            "DATASETS.TEST.IMG_HEIGHT", h, "DATASETS.TEST.IMG_WIDTH", w,
            "DATASETS.TRAIN.LENGTH", CLI_TRAIN_LENGTH, "DATASETS.TEST.LENGTH", CLI_TEST_LENGTH,
            "SOLVER.MAX_EPOCHS", CLI_EPOCHS, "SOLVER.CHECKPOINT_PERIOD", 1, "TEST.EVAL_PERIOD", 1,
            "LOG_PERIOD", 1, "OUTPUT_DIR", out, *extra]


def _expected_launches(steps: int, precise_bn_batches: int = 0) -> dict:
    return {k: MONO_PER_STEP[k] * steps + PRECISE_BN_PER_BATCH[k] * precise_bn_batches for k in MONO_PER_STEP}


def phase_default_trainer_path(device):
    """``tools/train_net_torch.py``'s ``main`` in this process: ``DefaultTrainer``
    with its hooks, PreciseBN over 2 batches at each epoch's end, a
    ``torch.profiler`` trace of one iteration, then ``--eval``. Checked: a step row
    for every iteration with finite losses, two evaluation rows, both checkpoints,
    the trace, that the epoch-0 checkpoint holds PreciseBN's statistics (recomputed
    from it on the same two batches), that ``--eval`` gives the last evaluation row
    exactly, and the exact launches of K1-K4 (steps x 4/8/4/4 + PreciseBN batches
    x 4/8/0/0; K5 never)."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from simpledepthestimation_tpu_torch.data import build_train_loader
    from simpledepthestimation_tpu_torch.engine import assemble_cfg, default_argument_parser, restore_inference_state
    from simpledepthestimation_tpu_torch.parallel import compute_precise_bn_stats

    out = tempfile.mkdtemp(prefix="sde_hook_")
    try:
        argv = [str(a) for a in _mono_cli_argv(out, (
            "TEST.PRECISE_BN.ENABLED", "True", "TEST.PRECISE_BN.NUM_ITER", PRECISE_BN_ITERS,
            "TPU.PROFILE_ITERS", f"({PROFILE_ITER},)"))]
        run_dir = os.path.join(out, "MonoDepth2_synthetic_quick")
        steps_per_epoch = CLI_TRAIN_LENGTH // SMOKE_B
        n_steps = CLI_EPOCHS * steps_per_epoch
        tool = _tool("train_net")

        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            trainer = tool.main(argv)
        train_s = time.perf_counter() - t0
        launches = read_launch_counts()
        if trainer.device.type != "cuda" or next(trainer.model.parameters()).device.type != "cuda":
            raise AssertionError("default_trainer_path: the model did not train on the card")
        del trainer
        want = _expected_launches(n_steps, CLI_EPOCHS * PRECISE_BN_ITERS)
        if launches != want:
            raise AssertionError(f"default_trainer_path: launches {launches}, expected {want}")

        rows = _metric_rows(run_dir)
        evals = _check_cli_rows(rows, range(n_steps), CLI_EPOCHS, "default_trainer_path")
        if [r["iteration"] for r in evals] != [steps_per_epoch - 1, n_steps]:
            raise AssertionError(f"default_trainer_path: evaluation rows at {[r['iteration'] for r in evals]}")
        ckpts = sorted(f for f in os.listdir(run_dir) if f.startswith("model_"))
        if ckpts != [f"model_{e:04d}.pth" for e in range(CLI_EPOCHS)]:
            raise AssertionError(f"default_trainer_path: checkpoints {ckpts}")
        trace = os.path.join(run_dir, f"profiler-trace-iter{PROFILE_ITER}", "trace.json")
        if not os.path.isfile(trace) or os.path.getsize(trace) == 0:
            raise AssertionError(f"default_trainer_path: no profiler trace at {trace}")
        with open(trace) as f:
            trace_events = json.load(f).get("traceEvents", [])
        kernel_events = sum(1 for e in trace_events if e.get("cat") == "kernel")

        with contextlib.redirect_stdout(sys.stderr):
            results = tool.main(["--eval"] + argv)
        got = {k: results["kitti evaluator"][k] for k in CLI_EVAL_KEYS}
        last = {k: evals[-1][f"kitti evaluator/{k}"] for k in CLI_EVAL_KEYS}
        if got != last:
            raise AssertionError(f"default_trainer_path: --eval gave {got}, the last evaluation row {last}")

        # the epoch-0 checkpoint carries PreciseBN's statistics: recomputed from its own weights
        # on the two batches the hook read (the loader at epoch 0), they come out the same
        cfg = assemble_cfg(default_argument_parser().parse_args(
            argv + ["MODEL.WEIGHTS", os.path.join(run_dir, "model_0000.pth")]))
        state, _ = restore_inference_state(cfg, device)
        saved = {k: v.clone() for k, v in state.model.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        loader = build_train_loader(cfg, seed=cfg.SEED, pin_memory=True)
        loader.set_epoch(0)
        source = iter(loader)
        try:
            batches = [{k: v.to(device) for k, v in b.items() if isinstance(v, torch.Tensor)}
                       for _, b in zip(range(PRECISE_BN_ITERS), source)]
        finally:
            source.close()
        compute_precise_bn_stats(state, batches)
        recomputed = state.model.state_dict()
        precise_err = max(float((recomputed[k] - v).abs().max() / v.abs().max()) for k, v in saved.items())
        if precise_err > 1e-5:
            raise AssertionError(f"default_trainer_path: the epoch-0 checkpoint's statistics are {precise_err} "
                                 "off PreciseBN's, recomputed from it")
        del state, batches
        torch.cuda.empty_cache()
        emit({
            "phase": "default_trainer_path", "model": "MonoDepth2-R18", "entry_point": "tools/train_net_torch.py",
            "batch": SMOKE_B, "hw": list(PLANES[0]), "epochs": CLI_EPOCHS, "steps": n_steps,
            "precise_bn_batches": CLI_EPOCHS * PRECISE_BN_ITERS, "launches": launches, "checkpoints": ckpts,
            "profiler_trace": os.path.relpath(trace, out), "trace_kernel_events": kernel_events,
            "precise_bn_recomputed_max_rel_err": precise_err,
            "median_step_wall_s": _median([r["time"] for r in rows if "time" in r]),
            "train_run_s": train_s, "eval": got,
        })
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_async_vis_path(device):
    """``projects/MonoDepth2/train_torch.py`` with ``TEST.ASYNC True`` and
    ``VIS_PERIOD 2`` for two epochs. Checked: epoch 0's evaluation row equals a
    synchronous ``do_test`` of ``model_0000.pth`` exactly (the snapshot was not
    overwritten by epoch 1's updates), the panels (6 of ``train/depth_pred`` and
    6 of ``train/image``, [192, 640, 3] uint8), no image left in the storage at
    the end, and the launches (12 steps x 4/8/4/4). Then the same run with
    ``TEST.ASYNC`` off, off and on again (the host's pace drifts within a call,
    so the two settings take turns): each run's wall time and median loop step,
    printed (not gated)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from simpledepthestimation_tpu_torch.engine import assemble_cfg, default_argument_parser, do_test
    from simpledepthestimation_tpu_torch.engine import restore_inference_state, runtime
    from simpledepthestimation_tpu_torch.utils.events import EventStorage

    class RecordingStorage(EventStorage):
        made = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.images = []
            RecordingStorage.made.append(self)

        def put_image(self, img_name, img):
            self.images.append((img_name, self.iter, list(np.shape(img)), str(np.asarray(img).dtype)))
            super().put_image(img_name, img)

    steps_per_epoch = CLI_TRAIN_LENGTH // SMOKE_B
    n_steps = CLI_EPOCHS * steps_per_epoch
    out = tempfile.mkdtemp(prefix="sde_async_")
    original = runtime.EventStorage
    runtime.EventStorage = RecordingStorage
    try:
        timing = {"on": [], "off": []}
        for i, async_eval in enumerate((True, False, False, True)):
            argv = _mono_cli_argv(os.path.join(out, str(i)), ("TEST.ASYNC", async_eval, "VIS_PERIOD", VIS_PERIOD))
            reset_launch_counts()
            t0 = time.perf_counter()
            _cli("MonoDepth2", argv)
            run_s = time.perf_counter() - t0
            counts = read_launch_counts()
            run_dir = os.path.join(out, str(i), "MonoDepth2_synthetic_quick")
            rows = _metric_rows(run_dir)
            steps = [r for r in rows if "total_loss" in r]
            timing["on" if async_eval else "off"].append({
                "run_s": run_s, "median_step_wall_s": _median([r["time"] for r in steps]),
                "median_epoch1_step_wall_s": _median([r["time"] for r in steps if r["iteration"] >= steps_per_epoch]),
            })
            if i == 0:  # the checked run
                launches, checked_rows, checked_dir, cfg_argv = counts, rows, run_dir, argv
            else:  # a run for the times only: its checkpoints are not read
                shutil.rmtree(os.path.join(out, str(i)), ignore_errors=True)
        if launches != _expected_launches(n_steps):
            raise AssertionError(f"async_vis_path: launches {launches}, expected {_expected_launches(n_steps)}")

        evals = _check_cli_rows(checked_rows, range(n_steps), CLI_EPOCHS, "async_vis_path")
        stamps = [r["iteration"] for r in evals]
        if stamps != [n_steps, n_steps + 1]:  # the JAX package's max(at_iter, storage.iter + 1, last + 1)
            raise AssertionError(f"async_vis_path: evaluation rows stamped {stamps}")
        cfg = assemble_cfg(default_argument_parser().parse_args(
            [str(a) for a in cfg_argv] + ["MODEL.WEIGHTS", os.path.join(checked_dir, "model_0000.pth")]))
        state, _ = restore_inference_state(cfg, device)
        sync = do_test(cfg, state=state)["kitti evaluator"]
        epoch0 = {k: evals[0][f"kitti evaluator/{k}"] for k in CLI_EVAL_KEYS}
        if {k: sync[k] for k in CLI_EVAL_KEYS} != epoch0:
            raise AssertionError(f"async_vis_path: epoch 0's asynchronous row {epoch0} is not the synchronous "
                                 f"evaluation of model_0000.pth {sync}")
        del state

        storage = RecordingStorage.made[0]
        h, w = PLANES[0]
        want = [(name, it, [h, w, 3], "uint8") for it in range(VIS_PERIOD, n_steps + 1, VIS_PERIOD)
                for name in ("train/depth_pred", "train/image")]
        if storage.images != want:
            raise AssertionError(f"async_vis_path: panels {storage.images}, expected {want}")
        if storage._vis_data or storage._histograms:
            raise AssertionError(f"async_vis_path: {len(storage._vis_data)} images left in the storage")
        torch.cuda.empty_cache()
        emit({
            "phase": "async_vis_path", "model": "MonoDepth2-R18", "entry_point": "projects/MonoDepth2/train_torch.py",
            "batch": SMOKE_B, "hw": [h, w], "epochs": CLI_EPOCHS, "steps": n_steps, "launches": launches,
            "eval_stamps": stamps, "epoch0_eval": epoch0, "panels": len(storage.images),
            "async_on": timing["on"], "async_off": timing["off"],
        })
        return launches
    finally:
        runtime.EventStorage = original
        shutil.rmtree(out, ignore_errors=True)


# --- Waymo: the three resnet18_waymo.yaml through their entry points, on one fabricated tree ---

WAYMO_HW = (1280, 1920)  # a FRONT camera frame
WAYMO_SEGMENTS, WAYMO_FRAMES = 2, 40  # frames a segment
WAYMO_SHIFT = 4  # pixels the scene moves sideways between frames (1 at 480 wide, after the resize)
WAYMO_FOCAL, WAYMO_CENTER = 2055.5, (939.7, 641.1)
WAYMO_SUPERVISED_TRAIN = 32  # frames in the Supervised train split: 2 steps at B=16
WAYMO_DECODE_FRAMES = 16  # frames the JPEG decode is timed on


def environment_line() -> dict:
    """What this Python imports for the frames: Pillow (and the libjpeg-turbo it
    was built with) and OpenCV, or ``None`` where one does not import."""
    out = {"phase": "environment", "python": sys.version.split()[0]}
    try:
        import PIL
        from PIL import features

        out.update(pillow=PIL.__version__, libjpeg_turbo=features.version_feature("libjpeg_turbo"))
    except ImportError:
        out.update(pillow=None, libjpeg_turbo=None)
    try:
        import cv2

        out["cv2"] = cv2.__version__
    except ImportError:
        out["cv2"] = None
    return out


def _waymo_rel(seg: int, i: int) -> str:
    return os.path.join(f"segment-{seg}", f"{i:05d}")


def _waymo_frame_files(tree, i: int, seg: int, field, rng) -> None:
    """Frame ``i`` of segment ``seg``: its JPEG (4:2:0, Pillow), the camera-Z depth
    of a seeded point cloud (the port's ``waymo_extract``, a 16-bit PNG) and a
    mask of 0/255 blobs (an 8-bit PNG). The PNG files are the port's writer's
    (filter 0 on every row: the reader's fast path)."""
    import numpy as np
    from PIL import Image

    from simpledepthestimation_tpu_torch.data.datasets import waymo_extract as wx
    from simpledepthestimation_tpu_torch.data.png import write_png

    H, W = WAYMO_HW
    rel = _waymo_rel(seg, i)
    frame = field[:, :, i * WAYMO_SHIFT: i * WAYMO_SHIFT + W].transpose(1, 2, 0)
    Image.fromarray((frame * 255).astype(np.uint8)).save(
        os.path.join(tree["image"], rel, "FRONT.jpg"), quality=90, subsampling=2)
    n = 60000
    pts = np.stack([rng.uniform(4, 80, n), rng.uniform(-30, 30, n), rng.uniform(-2.1, 3.0, n)], axis=-1)
    extrinsic = np.eye(4)
    extrinsic[:3, 3] = [1.5, 0.0, 2.1]
    u, v, depth = wx.project_points_to_camera(pts, extrinsic, wx.intrinsic_matrix4(WAYMO_FOCAL, WAYMO_FOCAL,
                                                                                    *WAYMO_CENTER))
    write_png(os.path.join(tree["depth"], rel, "FRONT_depth.png"),
              wx.encode_depth_png(wx.scatter_depth_image(H, W, np.round(u), np.round(v), depth)))
    blobs = (rng.random((H // 64, W // 64)) > 0.7).astype(np.uint8) * 255
    write_png(os.path.join(tree["mask"], rel, "FRONT_mask.png"), blobs.repeat(64, 0).repeat(64, 1))


def waymo_tree() -> dict:
    """The extracted Waymo tree that every Waymo phase reads: two segments of
    40 ``FRONT`` frames at 1280x1920, each a smooth random field that moves 4 px
    sideways a frame (on white noise the automask leaves the warp no gradient),
    laid out as ``tools/extract_waymo_data.py`` writes it, and three infos
    pickles (the port's ``build_frame_info``/``assemble_infos``): every frame
    (``training``, ``validation``) and the first 32 (``supervised_train``). In a
    temporary directory, removed when the script exits."""
    import atexit
    import pickle
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from simpledepthestimation_tpu_torch.data.datasets import waymo_extract as wx

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sde_waymo_")
    atexit.register(shutil.rmtree, root, True)
    tree = {k: os.path.join(root, k) for k in ("image", "depth", "mask")}
    K = np.array([[WAYMO_FOCAL, 0, WAYMO_CENTER[0]], [0, WAYMO_FOCAL, WAYMO_CENTER[1]], [0, 0, 1]], np.float32)
    calib = {"FRONT": {"intrinsics": K, "extrinsics": np.eye(4, dtype=np.float32)}}
    rng = np.random.RandomState(31)
    segments = []
    with ThreadPoolExecutor(8) as pool:
        jobs = []
        for seg in range(WAYMO_SEGMENTS):
            field = smooth_field(rng, 1, WAYMO_HW[0], WAYMO_HW[1] + WAYMO_SHIFT * WAYMO_FRAMES, cell=32)[0]
            frames = []
            for i in range(WAYMO_FRAMES):
                for d in ("image", "depth", "mask"):
                    os.makedirs(os.path.join(tree[d], _waymo_rel(seg, i)), exist_ok=True)
                jobs.append(pool.submit(_waymo_frame_files, tree, i, seg, field,
                                        np.random.default_rng(1000 * seg + i)))
                frames.append(wx.build_frame_info(f"segment-{seg}", i, _waymo_rel(seg, i), calib))
            segments.append(frames)
        for job in jobs:
            job.result()
    infos = {"training": wx.assemble_infos(segments), "validation": wx.assemble_infos(segments),
             "supervised_train": wx.assemble_infos([segments[0][:WAYMO_SUPERVISED_TRAIN]])}
    for name, payload in infos.items():
        tree[name] = os.path.join(root, f"{name}_infos.pkl")
        with open(tree[name], "wb") as f:
            pickle.dump(payload, f)
    tree["frames"] = [os.path.join(tree["image"], fr["rel_dir"], "FRONT.jpg") for fr in infos["training"]["frames"]]
    tree["seconds"] = time.perf_counter() - t0
    return tree


def _jpeg_decode_ms(paths) -> float:
    """Median milliseconds of one ``read_jpeg`` of each path (the loader's reader)."""
    from simpledepthestimation_tpu_torch.data.jpeg import read_jpeg

    times = []
    for p in paths:
        t0 = time.perf_counter()
        read_jpeg(p)
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def _out_hw(ds_cfg):
    """[H, W] of the frames a Waymo preprocess list gives: its ``Resize`` or
    ``RandomCrop``, else ``CropTopTo``'s rows of the full width."""
    ops = {p["NAME"]: p for p in ds_cfg.PREPROCESS}
    for name in ("Resize", "RandomCrop"):
        if name in ops:
            return [int(ops[name]["IMG_H"]), int(ops[name]["IMG_W"])]
    return [int(ops["CropTopTo"]["IMG_H"]), WAYMO_HW[1]]


def _waymo_cli_train_path(tree, phase, project, model_name, epochs, per_step, absent, train_split="training",
                          timings=False):
    """``projects/<project>/train_torch.py`` on ``configs/resnet18_waymo.yaml`` as
    shipped (``18pt``, B=16, bf16; MonoDepth2 192x480, MotionLearning 128x416 with
    masks, Supervised a 352x704 crop and evaluation at 768x1920) on the
    fabricated tree, with only the tree's paths, ``OUTPUT_DIR``,
    ``SOLVER.MAX_EPOCHS`` (``epochs``) and ``LOG_PERIOD`` 1 (a row for every
    step) overridden: ``epochs`` epochs with a checkpoint and an evaluation
    (four frames, ``DOWNSAMPLE`` 20) after each, then ``--eval``. Checked: finite
    losses in every row, the checkpoints, the evaluation rows, ``--eval`` equal
    to the last row, and the kernels' launches in training (``per_step``: name ->
    exact count a step, or None for at least one; ``absent``: never)."""
    import shutil
    import tempfile

    import torch

    from simpledepthestimation_tpu_torch.data import DATASET_REGISTRY
    from simpledepthestimation_tpu_torch.engine import assemble_cfg, default_argument_parser

    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="sde_waymo_cli_")
    try:
        argv = ["--cfg", os.path.join(root, "projects", project, "configs", "resnet18_waymo.yaml")]
        for split, infos in (("TRAIN", tree[train_split]), ("TEST", tree["validation"])):
            argv += [f"DATASETS.{split}.DATA_ROOT", tree["image"], f"DATASETS.{split}.DEPTH_ROOT", tree["depth"],
                     f"DATASETS.{split}.SPLIT", infos]
        if project == "MotionLearning":
            argv += ["DATASETS.TRAIN.MASK_ROOT", tree["mask"]]
        argv += ["SOLVER.MAX_EPOCHS", epochs, "LOG_PERIOD", 1, "OUTPUT_DIR", out]
        run_dir = os.path.join(out, f"{project}_resnet18_waymo")
        cfg = assemble_cfg(default_argument_parser().parse_args([str(a) for a in argv]))
        if int(cfg.SOLVER.IMS_PER_BATCH) != SMOKE_B or str(cfg.TPU.COMPUTE_DTYPE) != "bfloat16":
            raise AssertionError(f"{phase}: the shipped config is not B={SMOKE_B} bf16")
        steps_per_epoch = len(DATASET_REGISTRY.get(cfg.DATASETS.TRAIN.NAME)(cfg.DATASETS.TRAIN, cfg)) // SMOKE_B
        extra = {}
        if timings:
            extra["jpeg_decode_ms_per_frame"] = _jpeg_decode_ms(tree["frames"][:WAYMO_DECODE_FRAMES])
            extra["loader_alone_batch_s"] = _loader_alone_s(argv)

        reset_launch_counts()
        t0 = time.perf_counter()
        state = _cli(project, argv)
        train_s = time.perf_counter() - t0
        launches = read_launch_counts()
        if next(state.model.parameters()).device.type != "cuda":
            raise AssertionError(f"{phase}: the model did not train on the card")
        del state
        rows = _metric_rows(run_dir)
        steps = [r for r in rows if "total_loss" in r]
        evals = _check_cli_rows(rows, range(epochs * steps_per_epoch), epochs, phase)
        ckpts = sorted(f for f in os.listdir(run_dir) if f.startswith("model_"))
        if ckpts != [f"model_{e:04d}.pth" for e in range(epochs)]:
            raise AssertionError(f"{phase}: checkpoints {ckpts}")

        t0 = time.perf_counter()
        results = _cli(project, ["--eval"] + argv)
        eval_s = time.perf_counter() - t0
        got = {k: results["kitti evaluator"][k] for k in CLI_EVAL_KEYS}
        want = {k: evals[-1][f"kitti evaluator/{k}"] for k in CLI_EVAL_KEYS}
        if got != want:
            raise AssertionError(f"{phase}: --eval gave {got}, the last evaluation row of training {want}")

        n_steps = epochs * steps_per_epoch
        for name, n in per_step.items():
            if (launches[name] < 1) if n is None else (launches[name] != n * n_steps):
                raise AssertionError(f"{phase}: {name} launched {launches[name]} times in {n_steps} steps, "
                                     f"expected {'at least 1' if n is None else n * n_steps}")
        if any(launches[name] for name in absent):
            raise AssertionError(f"{phase}: a kernel the path does not run was launched: {launches}")
        torch.cuda.empty_cache()
        emit({
            "phase": phase, "model": model_name, "entry_point": f"projects/{project}/train_torch.py",
            "config": f"projects/{project}/configs/resnet18_waymo.yaml", "batch": SMOKE_B,
            "train_hw": _out_hw(cfg.DATASETS.TRAIN), "test_hw": _out_hw(cfg.DATASETS.TEST),
            "frames": f"{WAYMO_SEGMENTS} segments x {WAYMO_FRAMES} JPEG {WAYMO_HW[0]}x{WAYMO_HW[1]}",
            "tree_s": tree["seconds"], "epochs": epochs, "steps": n_steps, "launches": launches,
            "checkpoints": ckpts, "median_step_wall_s": _median([r["time"] for r in steps]),
            "median_data_time_s": _median([r["data_time"] for r in steps]),
            "median_h2d_copy_s": _median([r["h2d_time"] for r in steps if "h2d_time" in r]),
            **extra, "train_run_s": train_s, "eval_run_s": eval_s,
            "eval": got,
        })
        return launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_waymo_cli_train_path(device, tree):
    return _waymo_cli_train_path(
        tree, "waymo_cli_train_path", "MonoDepth2", "MonoDepth2-R18", 2, MONO_PER_STEP, (), timings=True)


def phase_waymo_motion_cli_train_path(device, tree):
    return _waymo_cli_train_path(
        tree, "waymo_motion_cli_train_path", "MotionLearning", "MotionLearning-R18 (GoogleResNet-18 randLN + GoogleMotionNet)",
        1, {"warp_bilinear_fwd": None, "warp_bilinear_bwd_coords": None, "warp_bilinear_bwd_image": None},
        ("photometric_map_fwd", "photometric_map_bwd"))


def phase_waymo_supervised_cli_train_path(device, tree):
    return _waymo_cli_train_path(
        tree, "waymo_supervised_cli_train_path", "Supervised", "DepthResNet-18 (SupDepthModel)", 1, {}, KERNEL_NAMES,
        train_split="supervised_train")


def phase_jpeg_agreement(device, tree):
    """The port's JPEG reader (``data/jpeg.py``) against ``cv2.imread`` + BGR→RGB
    on the tree's frames, where OpenCV imports here; otherwise ``"cv2": null``."""
    import numpy as np

    from simpledepthestimation_tpu_torch.data.jpeg import read_jpeg

    paths = tree["frames"][:WAYMO_DECODE_FRAMES]
    rec = {"phase": "jpeg_agreement", **{k: v for k, v in environment_line().items() if k != "phase"},
           "frames": len(paths), "hw": list(WAYMO_HW), "port_ms_per_frame": _jpeg_decode_ms(paths)}
    if rec["cv2"] is not None:
        import cv2

        differing, times = 0, []
        for p in paths:
            t0 = time.perf_counter()
            want = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            times.append((time.perf_counter() - t0) * 1e3)
            got = read_jpeg(p)
            differing += int(np.count_nonzero(got != want)) if got.shape == want.shape else got.size
        rec.update(differing_values=differing, cv2_ms_per_frame=_median(times))
    emit(rec)
    if rec.get("differing_values"):
        raise AssertionError(f"the port's JPEG reader differs from cv2.imread: {rec}")


def phase_predictor_export_path(device):
    """MonoDepth2-R18 as shipped (``resnet18.yaml``, bf16, its test preprocess:
    ``Resize`` to 192x640), one checkpoint of its seeded weights, then:
    ``DefaultPredictor`` on two 375x1242 uint8 frames (depth of the frame's
    shape), ``export_inference`` at B=1 192x640 and ``load_exported`` (depth
    within 1e-6 of eager's), ``tools/demo_torch.py`` on the two frames as PNG
    files (two panels), and the ms per call of eager and exported inference
    (CUDA events) and of the predictor (host clock, preprocessing included)."""
    import contextlib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from simpledepthestimation_tpu_torch.data.png import read_png, write_png
    from simpledepthestimation_tpu_torch.engine import Checkpointer, DefaultPredictor, export_inference, load_exported
    from simpledepthestimation_tpu_torch.engine.export import InferenceModule
    from simpledepthestimation_tpu_torch.parallel import create_train_state

    out = tempfile.mkdtemp(prefix="sde_infer_")
    try:
        cfg = smoke_cfg(["OUTPUT_DIR", out])
        state = create_train_state(cfg, device=device, generator=torch.Generator().manual_seed(0))
        Checkpointer(out).save(0, state)
        model = state.model
        del state

        rng = np.random.RandomState(0)
        frames = [rng.randint(0, 256, PREDICTOR_FRAME + (3,)).astype(np.uint8) for _ in range(2)]
        predictor = DefaultPredictor(cfg, device=device)
        depth = predictor(frames[0])  # loads the checkpoint
        walls = []
        for frame in frames * 3:
            t0 = time.perf_counter()
            depth = predictor(frame)
            walls.append((time.perf_counter() - t0) * 1e3)
        if depth.shape != PREDICTOR_FRAME or not np.isfinite(depth).all() or not (depth > 0).all():
            raise AssertionError(f"predictor_export_path: depth {depth.shape}, finite {np.isfinite(depth).all()}")

        h, w = PLANES[0]
        path = os.path.join(out, "model.pt2")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            export_inference(cfg, path, batch=1, shape=(h, w), device=device)
        export_s = time.perf_counter() - t0
        with open(path + ".json") as f:
            meta = json.load(f)
        if meta["input"]["shape"] != [1, 3, h, w] or meta["platforms"] != ["cuda"]:
            raise AssertionError(f"predictor_export_path: sidecar {meta}")
        served = load_exported(path)
        eager = InferenceModule(predictor.state.model)
        img = torch.from_numpy(rng.rand(1, 3, h, w).astype(np.float32)).to(device)
        with torch.no_grad():
            want = eager(img)
        got = served(img)
        err = float((got - want).abs().max() / want.abs().max())
        if got.shape != want.shape or not torch.isfinite(got).all() or err > EXPORT_RTOL:
            raise AssertionError(f"predictor_export_path: exported depth {err} off eager's (limit {EXPORT_RTOL})")

        def eager_call():
            with torch.no_grad():
                eager(img)

        eager_ms, exported_ms = cuda_ms(eager_call), cuda_ms(lambda: served(img))

        frame_dir = os.path.join(out, "frames")
        os.makedirs(frame_dir)
        for i, frame in enumerate(frames):
            write_png(os.path.join(frame_dir, f"{i}.png"), frame)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            written = _tool("demo").main(["--cfg", os.path.join(os.path.dirname(os.path.abspath(__file__)), "projects",
                                                                "MonoDepth2", "configs", "resnet18.yaml"),
                                          "--input", frame_dir, "--output", os.path.join(out, "demo"),
                                          "MODEL.DEPTH_NET.ENCODER_NAME", "18pt", "MODEL.WEIGHTS", out])
        demo_s = time.perf_counter() - t0
        panels = [read_png(p) for p in written]
        if len(panels) != 2 or any(p.shape != (2 * PREDICTOR_FRAME[0], PREDICTOR_FRAME[1], 3) for p in panels):
            raise AssertionError(f"predictor_export_path: demo panels {[p.shape for p in panels]}")
        del model, predictor, eager, served
        torch.cuda.empty_cache()
        emit({
            "phase": "predictor_export_path", "model": "MonoDepth2-R18 (resnet18.yaml, bf16)",
            "predictor_frame": list(PREDICTOR_FRAME), "predictor_ms_median": _median(walls),
            "export_hw": [h, w], "export_s": export_s, "export_max_rel_err": err,
            "eager_ms": eager_ms, "exported_ms": exported_ms, "demo_panels": len(panels), "demo_run_s": demo_s,
        })
    finally:
        shutil.rmtree(out, ignore_errors=True)


# --- the Supervised family (no hand-written kernel on its path) ---

SUP_HW = (352, 704)  # projects/Supervised/configs/Base.yaml: RandomCrop IMG_H, IMG_W
SUP_FIXED_STEPS, SUP_FRESH_STEPS = 4, 2
KERNEL_NAMES = ("warp_bilinear_fwd", "photometric_map_fwd", "warp_bilinear_bwd_coords", "photometric_map_bwd",
                "warp_bilinear_bwd_image")
NO_KERNEL = {k: (0, 0) for k in KERNEL_NAMES}
# REMAT off and on from one state, bf16 on the card: the forward runs the same cuDNN algorithms on the
# same inputs twice, so the loss and the running statistics (which the recomputation must leave alone:
# a second update would move them by a momentum step, 1e-2 of their size) agree to the bit; the
# backward's algorithms add in another order, so grad_norm is held to 1e-3 (measured on NVIDIA H100
# 80GB HBM3, 700 W: loss and statistics 0, grad_norm 2.4e-4)
REMAT_LOSS_RTOL, REMAT_STATS_RTOL, REMAT_GRAD_NORM_RTOL = 0.0, 0.0, 1e-3
# cpu_agreement_bts, float32 (measured on the card, NVIDIA H100 80GB HBM3, 700 W, in brackets):
# the forward and the losses as the other agreements (AGREE_RTOL) [depth 8.4e-7, losses 2.2e-7].
# BTS-R50's gradient with train-mode BatchNorms is ill-conditioned in float32 (the port's and the
# JAX package's each lie up to 17 % per tensor from a float64 gradient; tests/test_torch_bts.py),
# so it is held globally, at about 3x the reading: grad_norm 5e-3 [1.4e-3], the flattened gradient's
# 1 - cosine 1e-3 [3.1e-4], relative L2 8e-2 [2.5e-2], per-tensor median 8e-2 [2.7e-2]; and Adam's
# first update, which moves every parameter by about the rate whatever its gradient's size, may put
# a parameter whose gradient is noise up to twice the rate from the CPU's [2.0e-4 = 2 x 1e-4]. With
# BN_NO_TRACK (no batch statistics) the gradient is well conditioned and held per tensor
# (GRAD_AGREE_RTOL) and in norm (GRAD_NORM_RTOL)
BTS_GRAD_NORM_RTOL, BTS_GRAD_ONE_MINUS_COS, BTS_GRAD_REL_L2, BTS_GRAD_MEDIAN = 5e-3, 1e-3, 8e-2, 8e-2
BTS_AGREE_HW = (128, 256)
# bfloat16, card vs CPU copy: the loss [7.2e-4], and the share of depth pixels on the same value
# (within 1e-6) [0.46]: the median pixel cannot be the check after ~70 bf16 convolutions, where
# rounding flips spread (tests/test_torch_bts.py)
BTS_BF16_LOSS_RTOL, BTS_BF16_SAME_SHARE = 2e-3, 0.15


def sup_cfg(name: str, extra=()):
    from simpledepthestimation_tpu_torch.config import get_cfg

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(root, "projects", "Supervised", "configs", name))
    cfg.merge_from_list(list(extra))
    return cfg


def make_sup_batch(seed: int, B: int, H: int, W: int, device):
    """A Supervised batch from a numpy seed, NCHW: smooth frames, a smooth
    ground-truth depth in (1.5, 39.5) with a third of its pixels set to one
    value at or below 1 (outside ``silog_loss``'s ``gt > 1`` mask), intrinsics
    (the KITTI focal scaling reads them), and a random flip per sample."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    img = smooth_field(rng, B, H, W)
    depth = (1.5 + 38.0 * smooth_field(rng, B, H, W)[:, :1]).astype(np.float32)
    depth[rng.rand(B, 1, H, W) < 1 / 3] = rng.rand()
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    batch = {"img": img, "depth": depth, "intrinsics": K, "flip": rng.rand(B) < 0.5}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _sup_train(phase, cfg, model_name, device, exempt_fn=None):
    """A few checked steps on one fixed batch (the loss must fall) and on fresh
    ones, then ``TIMED_STEPS`` back to back, at full width, through the port's
    entry points. No hand-written kernel may launch. Returns (state, step,
    records, steady ms, peak bytes, the fixed batch, the exempt names)."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step

    B, (H, W) = int(cfg.SOLVER.IMS_PER_BATCH), SUP_HW
    if B != SMOKE_B:
        raise AssertionError(f"config gives B={B}; expected {SMOKE_B}")
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    emit_warm_start(model_name, cfg, state)
    if next(state.model.parameters()).device.type != "cuda":
        raise AssertionError("create_train_state did not place the model on the card")
    exempt = frozenset(exempt_fn(state) if exempt_fn else ())
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.get("GRAD_CLIP", 0.0)))
    fixed = make_sup_batch(500, B, H, W, device)
    fresh = [make_sup_batch(501 + i, B, H, W, device) for i in range(SUP_FRESH_STEPS)]
    records, launches, steady_ms = _drive_train_step(
        state, step, [fixed] * SUP_FIXED_STEPS + fresh, fresh, NO_KERNEL, {"total_loss", "grad_norm", "silog_loss"},
        exempt=exempt)
    peak = torch.cuda.max_memory_allocated()
    first, last = records[0]["total_loss"], records[SUP_FIXED_STEPS - 1]["total_loss"]
    if not last < first:
        raise AssertionError(f"{phase}: silog_loss on the fixed batch did not fall: {first} -> {last}")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError(f"{phase}: a parameter left float32")
    depth = make_eval_step(state)(fixed)
    lo, hi = depth.min().item(), depth.max().item()
    if depth.shape != (B, 1, H, W) or not (torch.isfinite(depth).all() and lo > 0.0):
        raise AssertionError(f"{phase}: depth_pred after training is off: shape {tuple(depth.shape)}, min {lo}")
    return state, step, records, launches, steady_ms, peak, fixed, exempt, (lo, hi)


def phase_supervised_train_path(device):
    """``projects/Supervised/configs/resnet18.yaml`` as shipped: DepthResNet-18pt with
    ``UPSAMPLE_DEPTH``, ``adamw_poly``, bf16, B=16 at Base.yaml's 352x704 crop."""
    cfg = sup_cfg("resnet18.yaml")
    state, _, records, launches, steady_ms, peak, _, _, depth = _sup_train(
        "supervised_train_path", cfg, "Supervised DepthResNet-18", device)
    B, (H, W) = SMOKE_B, SUP_HW
    emit({
        "phase": "supervised_train_path", "model": "Supervised DepthResNet-18 (UPSAMPLE_DEPTH)", "batch": B,
        "hw": [H, W], "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "optimizer": str(cfg.SOLVER.OPT),
        "lr": state.scheduler.get_last_lr(), "steps": records, "launches": launches,
        "steady_step_ms": steady_ms, "steady_images_per_s": B / steady_ms * 1e3, "peak_mem_bytes": peak,
        "depth_after": list(depth),
    })
    return launches


def phase_bts_train_path(device):
    """``projects/Supervised/configs/bts_r50.yaml`` as shipped: BtsModel resnet50_bts,
    BTS_SIZE 512, DATASET kitti, the freeze rules, bf16, B=16 at 352x704. Then,
    from one saved state, one step with ``TPU.REMAT`` off and one with it on."""
    import torch

    from simpledepthestimation_tpu_torch.solver import frozen_parameter_names

    cfg = sup_cfg("bts_r50.yaml")
    frozen_of = lambda state: frozen_parameter_names(cfg, state.model)  # noqa: E731
    before = {}

    def exempt_fn(state):
        names = frozen_of(state)
        params = dict(state.model.named_parameters())
        before.update({k: params[k].detach().clone() for k in names})
        return names

    state, _, records, launches, steady_ms, peak, fixed, frozen, depth = _sup_train(
        "bts_train_path", cfg, "BTS-R50", device, exempt_fn=exempt_fn)
    params = dict(state.model.named_parameters())
    moved = [k for k in frozen if not torch.equal(params[k].detach(), before[k])]
    no_grad = [k for k in frozen if params[k].grad is None or not bool((params[k].grad != 0).any())]
    if len(frozen) != 99 or moved or no_grad:
        raise AssertionError(f"bts_train_path: {len(frozen)} frozen parameters, {len(moved)} of them moved "
                             f"(e.g. {moved[:3]}), {len(no_grad)} without a gradient")

    remat = _remat_off_and_on(state, fixed, "silog_loss")
    B, (H, W) = SMOKE_B, SUP_HW
    emit({
        "phase": "bts_train_path", "model": "BTS-R50 (resnet50_bts, BTS_SIZE 512, kitti focal scaling)",
        "batch": B, "hw": [H, W], "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "optimizer": str(cfg.SOLVER.OPT),
        "frozen_parameters": len(frozen), "steps": records, "launches": launches,
        "steady_step_ms": steady_ms, "steady_images_per_s": B / steady_ms * 1e3, "peak_mem_bytes": peak,
        "depth_after": list(depth), "remat": remat,
    })
    _check_remat("bts_train_path", remat)
    return launches


def _remat_off_and_on(state, batch, loss_key):
    """From one saved state, one step with ``TPU.REMAT`` off and one with it on:
    the two steps' losses, ``grad_norm`` and running statistics compared, and
    each step's peak memory, memory above the state and time."""
    import copy

    import torch

    from simpledepthestimation_tpu_torch.parallel import make_train_step

    saved = (copy.deepcopy(state.model.state_dict()), copy.deepcopy(state.optimizer.state_dict()),
             state.scheduler.state_dict(), state.step)
    runs = {}
    for remat in (False, True):
        state.model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.scheduler.load_state_dict(saved[2])
        state.step = saved[3]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = make_train_step(state, grad_clip=0.0, remat=remat)(batch)
        stop.record()
        torch.cuda.synchronize()
        runs[remat] = ({k: v.item() for k, v in metrics.items()},
                       {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k},
                       torch.cuda.max_memory_allocated(), torch.cuda.max_memory_allocated() - base,
                       start.elapsed_time(stop))
    (m0, s0, peak0, step0, ms0), (m1, s1, peak1, step1, ms1) = runs[False], runs[True]
    rec = {"loss_rel_err": abs(m1[loss_key] - m0[loss_key]) / abs(m0[loss_key]),
           "grad_norm_rel_err": abs(m1["grad_norm"] - m0["grad_norm"]) / abs(m0["grad_norm"])}
    if s0:
        rec["running_stats_rel_err"] = max(((s1[k] - s0[k]).abs().max() / s0[k].abs().max()).item() for k in s0)
        rec["running_stats_moved_by_the_step"] = max(
            ((s0[k] - saved[0][k]).abs().max() / saved[0][k].abs().max()).item() for k in s0)
    rec.update({"limits": [REMAT_LOSS_RTOL, REMAT_GRAD_NORM_RTOL, REMAT_STATS_RTOL],
                "peak_mem_bytes_off": peak0, "peak_mem_bytes_on": peak1,
                "step_mem_above_state_bytes_off": step0, "step_mem_above_state_bytes_on": step1,
                "step_ms_off": ms0, "step_ms_on": ms1, "metrics_off": m0, "metrics_on": m1})
    return rec


def _check_remat(phase, rec):
    """One step with TPU.REMAT gives the step without it (the running statistics
    moved once, where there are any) at a lower peak memory."""
    if (rec["loss_rel_err"] > REMAT_LOSS_RTOL or rec["grad_norm_rel_err"] > REMAT_GRAD_NORM_RTOL
            or rec.get("running_stats_rel_err", 0.0) > REMAT_STATS_RTOL):
        raise AssertionError(f"{phase}: one step with TPU.REMAT differs from one without it")
    if not rec.get("running_stats_moved_by_the_step", 1.0) > 0 or not rec["peak_mem_bytes_on"] < rec["peak_mem_bytes_off"]:
        raise AssertionError(f"{phase}: the REMAT step moved no statistic or did not lower the peak memory")


def phase_supervised_cli_train_path(device):
    """``projects/Supervised/train_torch.py`` on ``synthetic_quick.yaml`` turned into
    ``bts_r50.yaml``'s model (resnet50_bts, BTS_SIZE 512, kitti) at 352x704, B=16, bf16."""
    return _cli_train_path(
        "supervised_cli_train_path", "Supervised", "BTS-R50 (resnet50_bts, BTS_SIZE 512)", SUP_HW, {},
        absent=KERNEL_NAMES,
        model_overrides=("MODEL.DEPTH_NET.NAME", "BtsModel", "MODEL.DEPTH_NET.ENCODER_NAME", "resnet50_bts",
                         "MODEL.DEPTH_NET.BTS_SIZE", 512, "MODEL.DATASET", "kitti", "LOG_PERIOD", 1))


# --- PackNet01 on the MonoDepth2 step, and the rigid MotionLearning nets ---

PACKNET_FIXED_STEPS, PACKNET_FRESH_STEPS = 4, 2
PACKNET_AGREE_HW = (64, 128)  # PackNet packs five times: H and W multiples of 32
# per step and scale, as MonoDepth2-R18's step (phase_train_path)
PACKNET_PER_STEP = {"warp_bilinear_fwd": 4, "photometric_map_fwd": 8, "warp_bilinear_bwd_coords": 4,
                    "photometric_map_bwd": 4, "warp_bilinear_bwd_image": 0}
RIGID = ("MODEL.DEPTH_NET.NAME", "GoogleResNetv2", "MODEL.POSE_NET.NAME", "GooglePoseNet")
RIGID_LOSSES = {"rgb_l1_loss", "ssim_loss", "rot_loss", "trans_loss", "smooth_loss"}
# per step: the RGB-D warp (K1, K3 for its coordinates) and the cycle loss's warp (K1, K5 for its image)
RIGID_PER_STEP = {"warp_bilinear_fwd": 2, "warp_bilinear_bwd_coords": 1, "warp_bilinear_bwd_image": 1,
                  "photometric_map_fwd": 0, "photometric_map_bwd": 0}
# PackNet in bfloat16, card vs CPU copy: some 40 bf16 convolutions of fan-in up to 2048x25 through
# GroupNorms, so a rounding flip spreads and only a share of the depth pixels keeps the CPU copy's value
# (tests/test_torch_packnet.py: the same against the JAX package). Measured on the card (NVIDIA H100 80GB
# HBM3, 700 W): losses 5.1e-4, depth pixels on the CPU's value 46.9 %; limits 2e-3 and 15 %, BTS's
PACKNET_BF16_LOSS_RTOL, PACKNET_BF16_SAME_SHARE = 2e-3, 0.15
# cuDNN's float32 backward of the pose net's first block, on a batch whose pose gradient spans three
# orders of magnitude between its samples (PackNet's random depth sits near its 0.05 floor, so one
# sample's parallax is huge): 5.4e-2 (conv1's GroupNorm bias) and 3.9e-2 (conv1's kernel) of the
# tensor's largest (measured on NVIDIA H100 80GB HBM3, 700 W; the same from run to run and with
# cudnn.deterministic), while every other tensor agrees within GRAD_AGREE_RTOL. With cuDNN off (PyTorch's
# own CUDA convolutions) the card's float32 gradient agrees with the CPU copy on every tensor (6.2e-6):
# the phase checks that too, so that only cuDNN's algorithm is let off the per-tensor limit
CUDNN_F32_POSE_CONV1 = ("pose_net.conv1.0.weight", "pose_net.conv1.1.bias")
CUDNN_F32_POSE_CONV1_RTOL = 1e-1


def packnet_cfg(extra=()):
    from simpledepthestimation_tpu_torch.config import get_cfg

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(root, "projects", "MonoDepth2", "configs", "packnet_1a.yaml"))
    cfg.merge_from_list(list(extra))
    return cfg


def phase_packnet_train_path(device):
    """``projects/MonoDepth2/configs/packnet_1a.yaml`` as shipped: PackNet01 1A +
    PoseNet, B=8 at 192x640, N=2, bf16, ``adam_multistep``: 4 steps on one batch
    (the loss must fall), 2 fresh, 10 timed; then from a saved state one step
    with ``TPU.REMAT`` off and one with it on."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step

    cfg = packnet_cfg()
    B, (H, W), N = int(cfg.SOLVER.IMS_PER_BATCH), PLANES[0], int(cfg.MODEL.POSE_NET.NUM_CONTEXTS)
    if (B, N) != (8, SMOKE_N):
        raise AssertionError(f"packnet_1a.yaml gives B={B}, N={N}; expected 8, {SMOKE_N}")
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    emit_warm_start("PackNet01-1A", cfg, state, pretrained=False)
    if next(state.model.parameters()).device.type != "cuda" or type(state.model.depth_net).__name__ != "PackNet01":
        raise AssertionError("create_train_state did not place PackNet01 on the card")
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP))
    fixed = make_batch(700, B, H, W, N, device, smooth=True)
    fresh = [make_batch(701 + i, B, H, W, N, device, smooth=True) for i in range(PACKNET_FRESH_STEPS)]
    records, launches, steady_ms = _drive_train_step(
        state, step, [fixed] * PACKNET_FIXED_STEPS + fresh, fresh, {k: (n, n) for k, n in PACKNET_PER_STEP.items()},
        {"total_loss", "grad_norm", "rec_loss", "smooth_loss"}, exempt=ZERO_GRADIENT_BY_CONSTRUCTION)
    peak = torch.cuda.max_memory_allocated()
    first, last = records[0]["total_loss"], records[PACKNET_FIXED_STEPS - 1]["total_loss"]
    if not last < first:
        raise AssertionError(f"packnet_train_path: total_loss on the fixed batch did not fall: {first} -> {last}")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("packnet_train_path: a parameter left float32")
    depth = make_eval_step(state)(fixed)
    lo, hi = depth.min().item(), depth.max().item()
    if depth.shape != (B, 1, H, W) or not (torch.isfinite(depth).all() and lo > 0.0 and hi <= 80.0 * (1 + 1e-6)):
        raise AssertionError(f"packnet_train_path: depth_pred is off: shape {tuple(depth.shape)}, min {lo}, max {hi}")
    remat = _remat_off_and_on(state, fixed, "rec_loss")
    emit({
        "phase": "packnet_train_path", "model": "PackNet01-1A + PoseNet (packnet_1a.yaml)", "batch": B,
        "hw": [H, W], "contexts": N, "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "optimizer": str(cfg.SOLVER.OPT),
        "parameters": sum(p.numel() for p in state.model.parameters()), "steps": records, "launches": launches,
        "launches_per_step": PACKNET_PER_STEP, "steady_step_ms": steady_ms, "steady_images_per_s": B / steady_ms * 1e3,
        "peak_mem_bytes": peak, "depth_after": [lo, hi], "remat": remat,
    })
    _check_remat("packnet_train_path", remat)
    return launches


def phase_cpu_agreement_packnet(device):
    """PackNet01 on the card and on a CPU copy of the same weights, B=2 at 64x128:
    in float32 1A's forward and one train step (losses, gradient per tensor and
    global, one Adam update) and 1B's forward; in bfloat16 1A's loss pass and depth."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = ["TPU.COMPUTE_DTYPE", "float32"]
    batch = make_batch(800, 2, *PACKNET_AGREE_HW, SMOKE_N, "cpu", smooth=True)
    rec = {"phase": "cpu_agreement_packnet", "shape": [2, *PACKNET_AGREE_HW], "rtol": AGREE_RTOL}
    for version in ("1A", "1B"):
        d_card, d_cpu, l_card, l_cpu = _forward_both(packnet_cfg(f32 + ["MODEL.DEPTH_NET.VERSION", version]),
                                                     batch, device)
        rec[version] = {"depth_rel_err": ((d_card - d_cpu).abs() / d_cpu.abs()).max().item(),
                        "loss_rel_err": {k: abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}}
    d_card, d_cpu, l_card, l_cpu = _forward_both(packnet_cfg(), batch, device)
    rel16 = (d_card - d_cpu).abs() / d_cpu.abs()
    rec["bf16"] = {"loss_rel_err": {k: abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu},
                   "loss_rtol": PACKNET_BF16_LOSS_RTOL, "depth_rel_err_max": rel16.max().item(),
                   "depth_rel_err_mean": rel16.mean().item(), "depth_rel_err_median": rel16.median().item(),
                   "depth_same_share": (rel16 <= 1e-6).double().mean().item(),
                   "same_share_min": PACKNET_BF16_SAME_SHARE}
    emit(rec)
    for version in ("1A", "1B"):
        if rec[version]["depth_rel_err"] > AGREE_RTOL or max(rec[version]["loss_rel_err"].values()) > AGREE_RTOL:
            raise AssertionError(f"cpu_agreement_packnet: the card's {version} forward disagrees with the CPU copy")
    if (max(rec["bf16"]["loss_rel_err"].values()) > PACKNET_BF16_LOSS_RTOL
            or rec["bf16"]["depth_same_share"] < PACKNET_BF16_SAME_SHARE or not torch.isfinite(d_card).all()):
        raise AssertionError("cpu_agreement_packnet: the card's bfloat16 forward disagrees with the CPU copy")
    launched = _agree_train_step("cpu_agreement_packnet_train_step", packnet_cfg(f32), batch, device,
                                 grad_rtol={k: CUDNN_F32_POSE_CONV1_RTOL for k in CUDNN_F32_POSE_CONV1})
    if launched != PACKNET_PER_STEP:
        raise AssertionError(f"cpu_agreement_packnet: the card's step launched {launched}")

    # the same gradient with cuDNN off (PyTorch's own CUDA convolutions): every tensor, the pose
    # net's first block included, within GRAD_AGREE_RTOL, so that only cuDNN's float32 algorithm
    # is let off its limit above, and the kernels and the rest of the card's step are not
    from simpledepthestimation_tpu_torch.models import build_model

    cfg = packnet_cfg(f32)
    card = build_model(cfg, generator=torch.Generator().manual_seed(3))
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    cpu.load_state_dict(card.state_dict())
    torch.backends.cudnn.enabled = False
    try:
        sum(card({k: v.to(device) for k, v in batch.items()}, train=True).values()).backward()
    finally:
        torch.backends.cudnn.enabled = True
    sum(cpu(batch, train=True).values()).backward()
    g_max = max(p.grad.abs().max().item() for p in cpu.parameters())
    errs = {k: (q.grad.cpu() - p.grad).abs().max().item()
            / (g_max if k in ZERO_GRADIENT_BY_CONSTRUCTION else p.grad.abs().max().item())
            for (k, p), q in zip(cpu.named_parameters(), card.parameters())}
    worst = max(errs, key=errs.get)
    emit({"phase": "cpu_agreement_packnet_grad_without_cudnn", "worst_grad": worst, "worst_grad_rel_err": errs[worst],
          "grad_rtol": GRAD_AGREE_RTOL, "grad_rel_err_by_name": {k: errs[k] for k in CUDNN_F32_POSE_CONV1}})
    if errs[worst] > GRAD_AGREE_RTOL:
        raise AssertionError("cpu_agreement_packnet: the card's gradient without cuDNN disagrees with the CPU copy")


def phase_motion_rigid_train_path(device):
    """``projects/MotionLearning/configs/resnet18.yaml`` with GoogleResNetv2 and
    GooglePoseNet, the rest as shipped (randLN at the end of its noise ramp,
    clip_ste scales, ``18pt``), B=16 pairs at 128x416, bf16: 5 checked steps and 10
    timed. A ResNet-18 weight file in reach makes the warm start meet a net with
    no torchvision encoder: it must warn, load nothing and leave every weight as
    the seed made it."""
    import tempfile

    import torch

    from simpledepthestimation_tpu_torch.models import build_model
    from simpledepthestimation_tpu_torch.models.resnet import ResNetEncoder
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step

    with tempfile.TemporaryDirectory(prefix="sde_rigid_") as tmp:
        weights = os.path.join(tmp, "resnet18.pth")
        torch.save(ResNetEncoder(18).encoder.state_dict(), weights)
        cfg = motion_cfg([*RIGID, "MODEL.DEPTH_NET.PRETRAINED_WEIGHTS", weights])
        B, (H, W) = int(cfg.SOLVER.IMS_PER_BATCH), MOTION_HW
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    emit_warm_start("MotionLearning rigid (GoogleResNetv2 + GooglePoseNet)", cfg, state)
    seeded = build_model(cfg, generator=torch.Generator().manual_seed(0))
    changed = [k for k, v in seeded.state_dict().items() if not torch.equal(v, state.model.state_dict()[k])]
    if state.pretrained_weights is not None or changed:
        raise AssertionError(f"the warm start of a net without a torchvision encoder loaded something: "
                             f"{state.pretrained_weights}, {changed[:5]}")
    del seeded
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP), schedule_fn=lambda i: MOTION_SCHEDULE)
    batches = [make_motion_batch(900 + i, B, H, W, device) for i in range(MOTION_CHECKED_STEPS)]
    records, launches, steady_ms = _drive_train_step(
        state, step, batches, batches, {k: (n, n) for k, n in RIGID_PER_STEP.items()},
        RIGID_LOSSES | {"total_loss", "grad_norm"},
        nonzero_grads=("depth_net.conv1.weight", "depth_net.decoder.out_conv.weight", "pose_net.pose_pred.weight",
                       "pose_net.trans_scale", "pose_net.rot_scale"))
    depth = make_eval_step(state)(batches[0])
    lo, hi = depth.min().item(), depth.max().item()
    if depth.shape != (B, 1, H, W) or not (torch.isfinite(depth).all() and lo > 0.0):
        raise AssertionError(f"motion_rigid_train_path: depth_pred is off: shape {tuple(depth.shape)}, min {lo}")
    emit({
        "phase": "motion_rigid_train_path", "model": "MotionLearning rigid (GoogleResNetv2 randLN + GooglePoseNet)",
        "batch": B, "hw": [H, W], "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "optimizer": str(cfg.SOLVER.OPT),
        "schedule": MOTION_SCHEDULE, "steps": records, "launches": launches, "launches_per_step": RIGID_PER_STEP,
        "steady_step_ms": steady_ms, "steady_pairs_per_s": B / steady_ms * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "depth_after": [lo, hi],
    })
    return launches


# --- the report tools (tools/{bench_models,profile_step,trace_step,bench_loader}_torch.py) ---

NO_LAUNCH = dict.fromkeys(KERNEL_NAMES, 0)
MOTION_PER_STEP = {**NO_LAUNCH, "warp_bilinear_fwd": 2, "warp_bilinear_bwd_coords": 1, "warp_bilinear_bwd_image": 1}
BENCH_PER_STEP = {"Supervised-R18": NO_LAUNCH, "BTS-R50": NO_LAUNCH, "MonoDepth2-R18": MONO_PER_STEP,
                  "PackNet-1A": MONO_PER_STEP, "MotionLearning-R18": MOTION_PER_STEP}
# with LOSS.SSIM_WEIGHT 0 the map is the plain L1 mean (models/meta_arch.py): no K2, no K4;
# without the automask only the warped half is mapped: one K2 a scale
ABLATION_PER_STEP = {
    "full (ssim+automask+min)": MONO_PER_STEP,
    "no-ssim": {**MONO_PER_STEP, "photometric_map_fwd": 0, "photometric_map_bwd": 0},
    "no-automask": {**MONO_PER_STEP, "photometric_map_fwd": 4},
    "no-smooth": MONO_PER_STEP,
    "supervised-only (nets minus pose/warp)": NO_LAUNCH,
}
LOADER_WORKERS = 8
TRACE_TOP = 12


def _per_step(counts: dict, steps: int, expected: dict, label: str) -> dict:
    per_step = {k: v / steps for k, v in counts.items()}
    if per_step != expected:
        raise AssertionError(f"{label} launched {per_step} a step over {steps} steps, expected {expected}")
    return per_step


def phase_report_tools_path(device):
    """The four report tools in this process, through their functions: every
    family of ``bench_models_torch.CASES`` at its shape under the tool's
    protocol (5 warm steps, 6 chunks of 5), the five ``profile_step_torch``
    variants, ``trace_step_torch`` on the flagship at B=16 (its table beside the
    device busy time of the same step under ``_profile``), and
    ``bench_loader_torch`` cut to 8 workers and one measured epoch (no warm one) on
    the full 64-frame OpenCV-written tree, with the PNG read time of one frame as OpenCV
    wrote it and as the port writes it. Launches a step exact for each family
    and variant, and in the trace's table. The tools' own lines go to standard
    error. Returns the launches of the bench and the variants."""
    import contextlib
    import math
    import shutil
    import tempfile

    import torch

    bench, profile, trace, loader = (_tool(n) for n in ("bench_models", "profile_step", "trace_step", "bench_loader"))
    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNEL_NAMES, 0)
    rec = {"phase": "report_tools_path", "families": [], "ablations": []}
    tmp = tempfile.mkdtemp()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            for name, meta, dn, pose, B, H, W, opts in bench.CASES:
                reset_launch_counts()
                t0 = time.perf_counter()
                res = bench.bench_case(name, meta, dn, pose, B, H, W, opts, device=device)
                counts = read_launch_counts()
                if not math.isfinite(res["last_loss"]):
                    raise AssertionError(f"bench_models_torch {name}: loss {res['last_loss']}")
                per_step = _per_step(counts, res["steps"], BENCH_PER_STEP[name], f"bench_models_torch {name}")
                rec["families"].append({"name": name, "batch": B, "hw": [H, W], "opts": list(opts),
                                        "images_per_s": res["images_per_s"], "last_loss": res["last_loss"],
                                        "launches_per_step": per_step, "seconds": time.perf_counter() - t0})
                total = {k: total[k] + counts[k] for k in total}
                torch.cuda.empty_cache()

            batch = bench.flagship_batch(profile.B, profile.H, profile.W, device=device)
            for name, cfg in profile.variants("bfloat16").items():
                b = profile.supervised_batch(batch, profile.B, profile.H, profile.W) if name.startswith("supervised") \
                    else batch
                reset_launch_counts()
                dt = profile.time_step(cfg, b, device)
                counts = read_launch_counts()
                per_step = _per_step(counts, profile.WARM_STEPS + profile.STEPS, ABLATION_PER_STEP[name],
                                     f"profile_step_torch {name}")
                rec["ablations"].append({"name": name, "ms_per_step": dt * 1e3, "images_per_s": profile.B / dt,
                                         "launches_per_step": per_step})
                total = {k: total[k] + counts[k] for k in total}

            t0 = time.perf_counter()
            traced = trace.main(["--outdir", os.path.join(tmp, "trace"), "--top", str(TRACE_TOP)])
            trace_s = time.perf_counter() - t0
            _, step = bench.build_step(bench.flagship_cfg("bfloat16"), device)
        table = traced["table"]
        named = {k: sum(r[1] for r in table if f"{k}_kernel" in r[2][:60]) for k in KERNEL_NAMES}
        if named != MONO_PER_STEP:
            raise AssertionError(f"trace_step_torch's table names the kernels {named} times a step, "
                                 f"expected {MONO_PER_STEP}")
        busy = _profile(lambda: step(batch), "report_tools_flagship_step", top=5)
        rec["trace"] = {
            "batch": 16, "hw": [192, 640], "steps": trace.N_TRACE_STEPS, "seconds": trace_s,
            "trace_bytes": os.path.getsize(traced["trace"]),
            "total_ms_per_step": sum(r[0] for r in table),
            "launches_per_step": sum(r[1] for r in table),
            "profile_device_busy_ms": busy["device_busy_ms"],
            "top": [{"ms": ms, "launches": n, "name": k[:60], "source": src} for ms, n, k, src in table[:TRACE_TOP]],
            "hand_written": [{"ms": ms, "launches": n, "name": k[:60], "source": src} for ms, n, k, src in table
                             if any(f"{kn}_kernel" in k[:60] for kn in KERNEL_NAMES)],
            "rows_without_source": sum(1 for r in table if not r[3]),
        }
        if not rec["trace"]["hand_written"] or any(not r["source"] for r in rec["trace"]["hand_written"]):
            raise AssertionError(f"trace_step_torch found no port source line for a kernel: "
                                 f"{rec['trace']['hand_written']}")

        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            root = os.path.join(tmp, "kitti")
            split = loader.make_tree(root, n=64)
            tree_s = time.perf_counter() - t0
            read = loader.frame_read_ms(split, root)
            t0 = time.perf_counter()
            # no warm epoch: the frames were just written, so the page cache holds them
            rate = loader.images_per_s(root, split, LOADER_WORKERS, epochs=1, warm_epochs=0)
        rec["loader"] = {"frames": 64, "hw": [375, 1242], "workers": LOADER_WORKERS, "measured_epochs": 1,
                         "warm_epochs": 0,
                         "images_per_s": rate, "seconds": time.perf_counter() - t0, "tree_seconds": tree_s,
                         "png_read_ms_opencv_written": read["opencv_written_ms"],
                         "png_read_ms_port_written": read["port_written_ms"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["launches"] = total
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    return total


def phase_cpu_agreement_motion_rigid(device):
    """The rigid MotionLearning train step on the card and on a CPU copy, float32,
    B=2 64x96, noise 0 (the two devices' generators differ)."""
    cfg = motion_cfg([*RIGID, "TPU.COMPUTE_DTYPE", "float32"])
    schedule = lambda i: {"noise_stddev": 0.0, "motion_weight": 1.0}  # noqa: E731
    launched = _agree_train_step("cpu_agreement_motion_rigid_train_step", cfg, make_motion_batch(204, 2, 64, 96, "cpu"),
                                 device, grad_clip=10.0, schedule_fn=schedule)
    if launched != RIGID_PER_STEP:
        raise AssertionError(f"the card's rigid step launched {launched}, expected {RIGID_PER_STEP}")


def _grad_agreement(card, cpu):
    """Per-tensor ``max|Δ| / max|g|`` of the two models' gradients, the
    flattened gradients' 1 − cosine and relative L2."""
    import torch

    g_card = {k: p.grad.cpu().double() for k, p in card.named_parameters()}
    g_cpu = {k: p.grad.double() for k, p in cpu.named_parameters()}
    errs = {k: ((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()).item() for k in g_cpu}
    va = torch.cat([g_card[k].flatten() for k in g_cpu])
    vb = torch.cat([g_cpu[k].flatten() for k in g_cpu])
    return errs, 1.0 - (va @ vb / va.norm() / vb.norm()).item(), ((va - vb).norm() / vb.norm()).item()


def phase_cpu_agreement_bts(device):
    """BtsModel-R50 (bts_r50.yaml) on the card and on a CPU copy of the same weights,
    B=2 at 128x256: in float32 the forward, the train step's loss, gradient and one
    AdamW update with the freeze, and the gradient with BN_NO_TRACK; in bfloat16
    the loss pass and the depth."""
    import torch

    from simpledepthestimation_tpu_torch.models import build_model
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step
    from simpledepthestimation_tpu_torch.solver import frozen_parameter_names

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = sup_cfg("bts_r50.yaml", ["TPU.COMPUTE_DTYPE", "float32"])
    batch_cpu = make_sup_batch(600, 2, *BTS_AGREE_HW, "cpu")
    batch_card = {k: v.to(device) for k, v in batch_cpu.items()}
    d_card, d_cpu, l_card, l_cpu = _forward_both(cfg, batch_cpu, device)
    depth_err = ((d_card - d_cpu).abs() / d_cpu.abs()).max().item()
    fwd_loss_err = abs(l_card["silog_loss"] - l_cpu["silog_loss"]) / abs(l_cpu["silog_loss"])

    # one train step: train-mode BatchNorms, the freeze, AdamW
    card = create_train_state(cfg, generator=torch.Generator().manual_seed(3), steps_per_epoch=4)
    cpu = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(4), steps_per_epoch=4)
    cpu.model.load_state_dict(card.model.state_dict())
    start = {k: p.detach().cpu().clone() for k, p in cpu.model.named_parameters()}
    reset_launch_counts()
    m_card = {k: v.item() for k, v in make_train_step(card)(batch_card).items()}
    launched = read_launch_counts()
    m_cpu = {k: v.item() for k, v in make_train_step(cpu)(batch_cpu).items()}
    errs, one_minus_cos, grad_rel_l2 = _grad_agreement(card.model, cpu.model)
    grad_median = sorted(errs.values())[len(errs) // 2]
    loss_err = abs(m_card["silog_loss"] - m_cpu["silog_loss"]) / abs(m_cpu["silog_loss"])
    norm_err = abs(m_card["grad_norm"] - m_cpu["grad_norm"]) / abs(m_cpu["grad_norm"])
    frozen = set(frozen_parameter_names(cfg, cpu.model))
    p_card = {k: p.detach().cpu() for k, p in card.model.named_parameters()}
    p_cpu = {k: p.detach() for k, p in cpu.model.named_parameters()}
    frozen_moved = [k for k in frozen if not (torch.equal(p_card[k], start[k]) and torch.equal(p_cpu[k], start[k]))]
    still = [k for k in p_cpu if k not in frozen and (torch.equal(p_card[k], start[k]) or torch.equal(p_cpu[k], start[k]))]
    lr = float(cfg.SOLVER.DEPTH_LR)
    max_apart = max((p_card[k] - p_cpu[k]).abs().max().item() for k in p_cpu)

    # BN_NO_TRACK: the same weights, no batch statistics, a well-conditioned gradient
    cfg_nt = sup_cfg("bts_r50.yaml", ["TPU.COMPUTE_DTYPE", "float32", "MODEL.DEPTH_NET.BN_NO_TRACK", "True"])
    nt_card = build_model(cfg_nt, generator=torch.Generator().manual_seed(5))
    nt_cpu = build_model(cfg_nt, device="cpu", generator=torch.Generator().manual_seed(6))
    nt_cpu.load_state_dict(nt_card.state_dict())
    nt_card(batch_card, train=True)["silog_loss"].backward()
    nt_cpu(batch_cpu, train=True)["silog_loss"].backward()
    nt_errs, nt_one_minus_cos, nt_rel_l2 = _grad_agreement(nt_card, nt_cpu)
    nt_worst = max(nt_errs, key=nt_errs.get)

    # bfloat16, the shipped dtype: the loss pass and depth
    d16_card, d16_cpu, l16_card, l16_cpu = _forward_both(sup_cfg("bts_r50.yaml"), batch_cpu, device)
    rel16 = (d16_card - d16_cpu).abs() / d16_cpu.abs()
    loss16_err = abs(l16_card["silog_loss"] - l16_cpu["silog_loss"]) / abs(l16_cpu["silog_loss"])
    same16 = (rel16 <= 1e-6).double().mean().item()
    emit({"phase": "cpu_agreement_bts", "shape": [2, *BTS_AGREE_HW], "rtol": AGREE_RTOL,
          "depth_rel_err": depth_err, "forward_loss_rel_err": fwd_loss_err, "step_loss_rel_err": loss_err,
          "grad_norm_rel_err": norm_err, "grad_one_minus_cos": one_minus_cos, "grad_rel_l2": grad_rel_l2,
          "grad_median_rel_err": grad_median, "grad_worst": max(errs, key=errs.get),
          "grad_worst_rel_err": max(errs.values()),
          "grad_limits": [BTS_GRAD_NORM_RTOL, BTS_GRAD_ONE_MINUS_COS, BTS_GRAD_REL_L2, BTS_GRAD_MEDIAN],
          "frozen": len(frozen), "frozen_moved": frozen_moved[:5], "trainable_unmoved": still[:5],
          "update_max_apart": max_apart, "lr": lr,
          "bn_no_track": {"worst": nt_worst, "worst_rel_err": nt_errs[nt_worst], "rtol": GRAD_AGREE_RTOL,
                          "one_minus_cos": nt_one_minus_cos, "rel_l2": nt_rel_l2},
          "launches_on_card": launched,
          "bf16": {"loss_rel_err": loss16_err, "loss_rtol": BTS_BF16_LOSS_RTOL,
                   "depth_rel_err_max": rel16.max().item(), "depth_rel_err_mean": rel16.mean().item(),
                   "depth_rel_err_median": rel16.median().item(), "depth_same_share": same16,
                   "same_share_min": BTS_BF16_SAME_SHARE}})
    if depth_err > AGREE_RTOL or fwd_loss_err > AGREE_RTOL or loss_err > AGREE_RTOL:
        raise AssertionError("cpu_agreement_bts: the card's forward or loss disagrees with the CPU copy")
    if (norm_err > BTS_GRAD_NORM_RTOL or one_minus_cos > BTS_GRAD_ONE_MINUS_COS or grad_rel_l2 > BTS_GRAD_REL_L2
            or grad_median > BTS_GRAD_MEDIAN):
        raise AssertionError("cpu_agreement_bts: the card's train-mode gradient disagrees with the CPU copy")
    if nt_errs[nt_worst] > GRAD_AGREE_RTOL or nt_rel_l2 > GRAD_NORM_RTOL:
        raise AssertionError("cpu_agreement_bts: the card's BN_NO_TRACK gradient disagrees with the CPU copy")
    if len(frozen) != 99 or frozen_moved or still or max_apart > 2.5 * lr:
        raise AssertionError("cpu_agreement_bts: the AdamW update with the freeze disagrees with the CPU copy")
    if any(launched.values()):
        raise AssertionError(f"cpu_agreement_bts: the BTS step launched a hand-written kernel: {launched}")
    if loss16_err > BTS_BF16_LOSS_RTOL or same16 < BTS_BF16_SAME_SHARE or not torch.isfinite(d16_card).all():
        raise AssertionError("cpu_agreement_bts: the card's bfloat16 forward disagrees with the CPU copy")

def _agree_train_step(phase, cfg, batch_cpu, device, grad_clip=0.0, schedule_fn=None, grad_rtol=None):
    """One float32 train step on the card (kernels, cuDNN without TF32) and on a
    CPU copy of the same weights (plain versions): every loss, the global
    gradient norm, each parameter's gradient (within ``GRAD_AGREE_RTOL``, or
    the limit ``grad_rtol`` names for it) and the parameters after the update.
    Returns the launches of the card's step."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = create_train_state(cfg, generator=torch.Generator().manual_seed(3), steps_per_epoch=4)
    cpu = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(4), steps_per_epoch=4)
    cpu.model.load_state_dict(card.model.state_dict())
    start = {k: p.detach().cpu().clone() for k, p in card.model.named_parameters()}
    reset_launch_counts()
    m_card = {k: v.item() for k, v in make_train_step(card, grad_clip, schedule_fn)(
        {k: v.to(device) for k, v in batch_cpu.items()}).items()}
    launched = read_launch_counts()
    m_cpu = {k: v.item() for k, v in make_train_step(cpu, grad_clip, schedule_fn)(batch_cpu).items()}
    loss_err = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30) for k in m_cpu if k != "grad_norm"}
    norm_err = abs(m_card["grad_norm"] - m_cpu["grad_norm"]) / abs(m_cpu["grad_norm"])
    g_cpu = {k: p.grad for k, p in cpu.model.named_parameters()}
    g_card = {k: p.grad.cpu() for k, p in card.model.named_parameters()}
    # a gradient that is zero but for rounding is held against the largest gradient instead of its own
    g_max = max(g.abs().max().item() for g in g_cpu.values())
    grad_err = {k: (g_card[k] - g_cpu[k]).abs().max().item()
                / max(g_max if k in ZERO_GRADIENT_BY_CONSTRUCTION else g_cpu[k].abs().max().item(), 1e-30)
                for k in g_cpu}
    limit = {k: (grad_rtol or {}).get(k, GRAD_AGREE_RTOL) for k in grad_err}
    worst = max(grad_err, key=lambda k: grad_err[k] / limit[k])
    zero = [k for k, g in g_cpu.items() if k not in ZERO_GRADIENT_BY_CONSTRUCTION and not g.abs().max().item() > 0]
    # after the update: Adam's first step moves every parameter by the rate times
    # g/(|g| + eps), so where |g| is rounding noise the two sides may move apart by
    # up to twice the rate; elsewhere they agree. Held as a norm over all parameters.
    lr = float(cfg.SOLVER.DEPTH_LR)
    p_card = torch.cat([p.detach().cpu().flatten() for p in card.model.parameters()]).double()
    p_cpu = torch.cat([p.detach().flatten() for p in cpu.model.parameters()]).double()
    p_start = torch.cat([start[k].flatten() for k, _ in card.model.named_parameters()]).double()
    update_err = ((p_card - p_cpu).norm() / (p_cpu - p_start).norm()).item()
    max_apart = (p_card - p_cpu).abs().max().item()
    emit({"phase": phase, "shape": [int(batch_cpu["img"].shape[0]), *batch_cpu["img"].shape[2:]],
          "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err, "worst_grad": worst,
          "worst_grad_rel_err": grad_err[worst], "grad_rtol": GRAD_AGREE_RTOL, "zero_grads_cpu": zero,
          **({"grad_rtol_by_name": grad_rtol, "grad_rel_err_by_name": {k: grad_err[k] for k in grad_rtol}}
             if grad_rtol else {}),
          "update_rel_l2_err": update_err, "update_max_apart": max_apart, "lr": lr,
          "launches_on_card": launched, "metrics_card": m_card, "metrics_cpu": m_cpu})
    if max(loss_err.values()) > AGREE_RTOL or norm_err > GRAD_NORM_RTOL or grad_err[worst] > limit[worst]:
        raise AssertionError("the card's losses or parameter gradients disagree with the CPU copy of the model")
    if not m_cpu["grad_norm"] > 0 or zero:
        raise AssertionError("a gradient of the CPU copy is identically zero: the comparison says nothing")
    if update_err > 5e-2 or max_apart > 2.5 * lr:
        raise AssertionError("the parameters after one update disagree with the CPU copy of the model")
    return launched


def phase_cpu_agreement_motion(device):
    """The MotionLearning train step on the card and on a CPU copy, B=2 64x96,
    noise 0 (the two devices' generators differ), motion weight 1."""
    cfg = motion_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    schedule = lambda i: {"noise_stddev": 0.0, "motion_weight": 1.0}  # noqa: E731
    launched = _agree_train_step("cpu_agreement_motion_train_step", cfg, make_motion_batch(203, 2, 64, 96, "cpu"),
                                 device, grad_clip=10.0, schedule_fn=schedule)
    if launched["warp_bilinear_bwd_image"] != 1 or launched["warp_bilinear_bwd_coords"] != 1:
        raise AssertionError(f"the card's step did not run K3 and K5 once each: {launched}")


def _profile(fn, label: str, top: int, wall_iters: int = 10, ops=()):
    """Device time of one call of ``fn`` by kernel name, beside its wall time;
    with ``ops`` (operator names), also those operators' device time by input
    shape (their kernels included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):  # warm-up: cuDNN picks its algorithms
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(wall_iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / wall_iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=bool(ops)) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: operator rows repeat the time of the kernels they launch
    # (and not the optimizer's annotation range "Optimizer.step#Adam.step", which spans its kernels)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    rows = sorted(rows, key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    rec = {
        "phase": "profile", "call": label, "wall_ms": wall_ms, "device_busy_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_kernel_launches": sum(r[1] for r in rows),
        "top": [{"name": k[:80], "count": c, "ms": ms} for k, c, ms in rows[:top]],
        "hand_written": [{"name": k[:80], "count": c, "ms": ms} for k, c, ms in rows
                         if "warp_bilinear" in k or "photometric_map" in k],
    }
    if ops:
        # per operator and rank of its first input (a 3D convolution's is 5): the total, and the 3 largest shapes
        groups = {}
        for e in prof.key_averages(group_by_input_shape=True):
            if e.key in ops:
                rank = len(e.input_shapes[0]) if e.input_shapes and e.input_shapes[0] else 0
                groups.setdefault(f"{e.key} {rank}-D", []).append((str(e.input_shapes)[:120], e.count,
                                                                  e.device_time_total / 1e3))
        rec["ops"] = {name: {"count": sum(r[1] for r in rows), "ms": sum(r[2] for r in rows),
                             "largest": [{"shapes": sh, "count": c, "ms": ms}
                                         for sh, c, ms in sorted(rows, key=lambda r: -r[2])[:3]]}
                      for name, rows in sorted(groups.items())}
    emit(rec)
    return rec


def profile_paths(device, top: int = 14):
    """Optional (``--profile``): where the device time of one steady-state
    ``train=False`` forward, one loss pass and one train step of MonoDepth2, one
    MotionLearning train step, one PackNet train step and one rigid
    MotionLearning train step goes, by kernel name, and how much of the wall
    time the device is busy."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    cfg = smoke_cfg()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    batch = make_batch(300, SMOKE_B, *PLANES[0], SMOKE_N, device, smooth=True)

    def forward(train):
        with torch.no_grad():
            state.model(batch, train=train)

    _profile(lambda: forward(False), "depth_pred", top)
    _profile(lambda: forward(True), "loss_pass", top)
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP))
    _profile(lambda: step(batch), "train_step", top)
    del state, step

    cfg = motion_cfg()
    mstate = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    mstep = make_train_step(mstate, grad_clip=float(cfg.SOLVER.GRAD_CLIP), schedule_fn=lambda i: MOTION_SCHEDULE)
    mbatch = make_motion_batch(400, SMOKE_B, *MOTION_HW, device)
    _profile(lambda: mstep(mbatch), "motion_train_step", top)
    del mstate, mstep

    cfg = packnet_cfg()
    pstate = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    pstep = make_train_step(pstate)
    pbatch = make_batch(700, int(cfg.SOLVER.IMS_PER_BATCH), *PLANES[0], SMOKE_N, device, smooth=True)
    _profile(lambda: pstep(pbatch), "packnet_train_step", top,
             ops=("aten::cudnn_convolution", "aten::convolution_backward", "aten::native_group_norm",
                  "aten::native_group_norm_backward", "aten::elu", "aten::elu_backward"))
    del pstate, pstep

    cfg = motion_cfg(RIGID)
    rstate = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
    rstep = make_train_step(rstate, grad_clip=float(cfg.SOLVER.GRAD_CLIP), schedule_fn=lambda i: MOTION_SCHEDULE)
    _profile(lambda: rstep(mbatch), "motion_rigid_train_step", top)


def _forward_both(cfg, batch_cpu, device):
    """``depth_pred`` and the loss dict of one set of seeded weights, on the card
    and on a CPU copy of the model."""
    import torch

    from simpledepthestimation_tpu_torch.models import build_model

    on_card = build_model(cfg, generator=torch.Generator().manual_seed(1))
    on_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    on_cpu.load_state_dict(on_card.state_dict())
    batch_card = {k: v.to(device) for k, v in batch_cpu.items()}
    with torch.no_grad():
        d_card = on_card(batch_card, train=False)["depth_pred"].cpu()
        d_cpu = on_cpu(batch_cpu, train=False)["depth_pred"]
        l_card = {k: v.item() for k, v in on_card(batch_card, train=True).items()}
        l_cpu = {k: v.item() for k, v in on_cpu(batch_cpu, train=True).items()}
    return d_card, d_cpu, l_card, l_cpu


def phase_cpu_agreement(device):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    d_card, d_cpu, l_card, l_cpu = _forward_both(cfg, make_batch(200, 2, 64, 256, SMOKE_N, "cpu"), device)
    depth_err = ((d_card - d_cpu).abs() / d_cpu.abs().clamp_min(1.0)).max().item()
    loss_err = {k: abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    emit({"phase": "cpu_agreement", "shape": [2, 64, 256], "rtol": AGREE_RTOL,
          "depth_rel_err": depth_err, "loss_rel_err": loss_err, "losses_card": l_card, "losses_cpu": l_cpu})
    if set(l_card) != set(l_cpu) or depth_err > AGREE_RTOL or any(e > AGREE_RTOL for e in loss_err.values()):
        raise AssertionError("the card's forward disagrees with the CPU copy of the model")

    # one float32 train step on the card (kernels) and on the CPU copy (plain versions)
    _agree_train_step("cpu_agreement_train_step", cfg, make_batch(201, 2, 64, 256, SMOKE_N, "cpu", smooth=True),
                      device)

    # the same forward in bfloat16, the shipped yaml's dtype, on a smooth batch (the warp reaches the loss)
    cfg = smoke_cfg()
    d_card, d_cpu, l_card, l_cpu = _forward_both(cfg, make_batch(201, 2, 64, 256, SMOKE_N, "cpu", smooth=True),
                                                 device)
    depth_rel = (d_card - d_cpu).abs() / d_cpu.abs()
    loss_err = {k: abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    rec = {"phase": "cpu_agreement_bf16", "shape": [2, 64, 256], "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE),
           "loss_rel_err": loss_err, "loss_rtol": BF16_AGREE_LOSS_RTOL, "depth_rel_err_max": depth_rel.max().item(),
           "depth_rel_err_mean": depth_rel.mean().item(), "depth_rel_err_median": depth_rel.median().item(),
           "depth_rtol_max": BF16_AGREE_DEPTH_RTOL, "depth_rtol_median": BF16_AGREE_DEPTH_MEDIAN_RTOL,
           "depth_rtol_mean": BF16_AGREE_DEPTH_MEAN_RTOL, "reason": BF16_AGREE_REASON,
           "losses_card": l_card, "losses_cpu": l_cpu}
    emit(rec)
    if (set(l_card) != set(l_cpu) or any(e > BF16_AGREE_LOSS_RTOL for e in loss_err.values())
            or rec["depth_rel_err_max"] > BF16_AGREE_DEPTH_RTOL or rec["depth_rel_err_mean"] > BF16_AGREE_DEPTH_MEAN_RTOL
            or rec["depth_rel_err_median"] > BF16_AGREE_DEPTH_MEDIAN_RTOL
            or not torch.isfinite(d_card).all()):
        raise AssertionError("the card's bfloat16 forward disagrees with the CPU copy of the model")


# -- several processes ------------------------------------------------------------

MP_WORLD, MP_B, MP_STEPS = 2, 8, 3  # global batch 8: 4 rows a rank
MP_TIMEOUT_S = 300
# The first step: the JAX package's limits for its mesh against one device (tests/test_parallel.py:72-81,
# :175-180) for the losses, the parameters and the running statistics. The gradient: MonoDepth2-R18's train-mode
# float32 gradient at 192x640 is ill-conditioned (the BatchNorm backward cancels in the deep layers): the global
# path at world 1 (an NCCL group, no second rank) is off cuDNN's BatchNorm by 3.4e-4 in grad_norm and 8.8e-2 in
# layer4.0.conv1.weight (measured on an NVIDIA H100 80GB HBM3 at 700 W), so it is held as a whole, by the limits
# the BTS gradient is held to (1 - cosine 1e-4, relative L2 2e-2: ROADMAP.md C), grad_norm by
# tests/test_torch_train_step.py's first step (1e-3). After the first step: the losses by that file's trajectory
# bound (2e-3): Adam's first updates
# move a parameter by the rate whatever its gradient's size, so the rounding noise of the ill-conditioned
# gradients moves parameters fully and later grad_norms follow it (reported, not held); an evaluation of the
# trained model by 2e-3 (ROADMAP.md C).
MP_LOSS_RTOL, MP_PARAM_ATOL = 1e-5, 5e-4
MP_STATS_RTOL, MP_STATS_ATOL = 1e-5, 1e-6
MP_GRAD_NORM_RTOL, MP_GRAD_COS_TOL, MP_GRAD_REL_L2 = 1e-3, 1e-4, 2e-2
# world 2 against the same global path at world 1 (nccl_world1_path): grad_norm at the JAX package's 1e-4
MP_SAME_PATH_GRAD_NORM_RTOL = 1e-4
MP_TRAJ_LOSS_RTOL, MP_TRAJ_EVAL_RTOL = 2e-3, 2e-3
GLOO_ON_ONE_CARD = ("two ranks share the one card through gloo: NCCL takes one rank per card and refuses "
                    "two on one device")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rows(batch, rank: int, world: int):
    return {k: v[rank * (v.shape[0] // world):(rank + 1) * (v.shape[0] // world)] for k, v in batch.items()}


def _mp_cfgs():
    """MonoDepth2-R18 and MotionLearning-R18 as shipped, in float32 (cuDNN without TF32 below), at the
    global batch of this phase; the MotionLearning step at the ends of its schedule (noise 0.5)."""
    extra = ["TPU.COMPUTE_DTYPE", "float32", "SOLVER.IMS_PER_BATCH", MP_B]
    return smoke_cfg(extra), motion_cfg(extra)


def _mp_batches(device):
    H, W = PLANES[0]
    mono = [make_batch(900 + i, MP_B, H, W, SMOKE_N, device, smooth=True) for i in range(MP_STEPS)]
    return mono, make_motion_batch(950, MP_B, *MOTION_HW, device)


def _mp_steps(device, rank: int = 0, world: int = 1, names=("monodepth2", "motion")):
    """The phase's steps on this rank's rows (all of them at world 1): ``MP_STEPS``
    MonoDepth2 steps, then one MotionLearning step (of ``names``); per step the metrics, the launches,
    the collectives and the time (host clock around the step and a synchronise), the digest of the
    state after each model's steps, and the state after its first step (rank 0's tensors)."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step, mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_mono, cfg_motion = _mp_cfgs()
    mono, motion_batch = _mp_batches(device)
    out = {}
    for name, cfg, batches, schedule_fn in (("monodepth2", cfg_mono, mono, None),
                                            ("motion", cfg_motion, [motion_batch], lambda i: MOTION_SCHEDULE)):
        if name not in names:
            continue
        state = create_train_state(cfg, device=device, generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
        mesh.check_replicas_agree(state.model, f"the initial {name} model")
        step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP), schedule_fn=schedule_fn)
        records, first = [], None
        for batch in batches:
            reset_launch_counts()
            mesh.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(_rows(batch, rank, world))
            torch.cuda.synchronize()
            records.append({"ms": (time.perf_counter() - t0) * 1e3, "launches": read_launch_counts(),
                            "collectives": dict(mesh.collective_counts),
                            "metrics": {k: v.item() for k, v in metrics.items()}})
            if first is None and rank == 0:  # the global gradient (summed over ranks) and the state after it
                first = {"grads": {k: p.grad.detach().cpu().clone() for k, p in state.model.named_parameters()
                                   if p.grad is not None},
                         "state": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}}
        out[name] = {"steps": records, "digest": mesh.state_digest(state.model), "first": first}
    return out


def multiprocess_rank(rank: int, world: int, address: str, out_path: str) -> int:
    """One rank of ``multiprocess_path`` (``chip_smoke.py --multiprocess-rank``): a gloo group on
    ``cuda:0`` that this script makes, the steps of ``_mp_steps`` on the rank's rows, its results
    written to ``out_path``."""
    import datetime

    import torch
    import torch.distributed as dist

    from simpledepthestimation_tpu_torch.ops import cuda_lib
    from simpledepthestimation_tpu_torch.utils import comm

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    comm.init_process_group(f"tcp://{address}", world_size=world, rank=rank, backend="gloo",
                            timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    try:
        probe = torch.ones(4, device=device)
        dist.all_reduce(probe)
        if probe.tolist() != [float(world)] * 4:
            raise RuntimeError(f"the sum over {world} ranks of ones came out {probe.tolist()}")
    except RuntimeError as e:
        torch.save({"error": f"gloo refused CUDA tensors in all_reduce: {e}"}, out_path)
        return 3
    cuda_lib.load()  # built by the parent already
    torch.save(_mp_steps(device, rank, world), out_path)
    return 0


def _metric_errors(got, ref):
    """Per step, the worst relative error of the losses and that of ``grad_norm`` (lists of
    metric dicts, world N against world 1)."""
    loss = [max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-30) for k in r if k != "grad_norm") for g, r in zip(got, ref)]
    norm = [abs(g["grad_norm"] - r["grad_norm"]) / r["grad_norm"] for g, r in zip(got, ref)]
    return loss, norm


def _limits_past(loss_err, norm_err, grad_norm_rtol=MP_GRAD_NORM_RTOL) -> list:
    """The first step's losses and grad_norm, the later steps' losses: the names of the limits past."""
    return [name for name, past in (
        ("first-step losses", loss_err[0] > MP_LOSS_RTOL), ("first-step grad_norm", norm_err[0] > grad_norm_rtol),
        ("later losses", max(loss_err[1:], default=0.0) > MP_TRAJ_LOSS_RTOL)) if past]


def _mp_compare(got, ref, grad_norm_rtol=MP_GRAD_NORM_RTOL):
    """Metrics of each step, and the gradient of the first step and the state after it, ``got``
    (world N, rank 0) against ``ref`` (world 1): the worst relative error of the losses and of
    ``grad_norm`` by step; the whole gradient's 1 - cosine and relative L2 distance, and each
    parameter's gradient relative to its largest entry (the one zero but for rounding relative to
    the largest gradient), the worst five; the largest distance of a parameter (that one apart:
    Adam's first step moves it by the rate whatever the sign of the rounding) and the running
    statistics' excess over their relative limit. Returns the record and the limits it is past."""
    import torch

    loss_err, norm_err = _metric_errors([s["metrics"] for s in got["steps"]], [s["metrics"] for s in ref["steps"]])
    g_got, g_ref = got["first"]["grads"], ref["first"]["grads"]
    g_max = max(g.abs().max().item() for g in g_ref.values())
    grad_err = {k: (g_got[k] - g).abs().max().item()
                / max(g_max if k in ZERO_GRADIENT_BY_CONSTRUCTION else g.abs().max().item(), 1e-30)
                for k, g in g_ref.items()}
    flat_got = torch.cat([g_got[k].double().flatten() for k in g_ref])
    flat_ref = torch.cat([g.double().flatten() for g in g_ref.values()])
    cos_err = 1.0 - (flat_got @ flat_ref / (flat_got.norm() * flat_ref.norm())).item()
    rel_l2 = ((flat_got - flat_ref).norm() / flat_ref.norm()).item()
    param_apart, exempt_apart, stats_excess = 0.0, 0.0, 0.0
    for k, v in ref["first"]["state"].items():
        if not v.is_floating_point():
            continue
        diff = (got["first"]["state"][k].double() - v.double()).abs()
        if k.endswith(("running_mean", "running_var")):
            stats_excess = max(stats_excess, (diff - MP_STATS_RTOL * v.double().abs()).max().item())
        elif k in ZERO_GRADIENT_BY_CONSTRUCTION:
            exempt_apart = max(exempt_apart, diff.max().item())
        else:
            param_apart = max(param_apart, diff.max().item())
    rec = {"loss_rel_err_by_step": loss_err, "grad_norm_rel_err_by_step": norm_err,
           "grad_one_minus_cosine_first_step": cos_err, "grad_rel_l2_first_step": rel_l2,
           "grad_rel_err_worst_first_step": sorted(grad_err.items(), key=lambda kv: -kv[1])[:5],
           "param_max_apart_first_step": param_apart, "zero_gradient_param_max_apart_first_step": exempt_apart,
           "stats_excess_over_rtol_first_step": stats_excess}
    failed = _limits_past(loss_err, norm_err, grad_norm_rtol)
    if cos_err > MP_GRAD_COS_TOL or rel_l2 > MP_GRAD_REL_L2:
        failed.append("gradient")
    if param_apart > MP_PARAM_ATOL:
        failed.append("parameters")
    if stats_excess > MP_STATS_ATOL:
        failed.append("running statistics")
    if not all(torch.isfinite(t).all() for t in got["first"]["state"].values() if t.is_floating_point()):
        failed.append("finite state")
    return rec, failed


def phase_multiprocess_path(device):
    """Two processes on the one card in a gloo group (``GLOO_ON_ONE_CARD``), MonoDepth2-R18 at full
    width (192x640, global B=8, 4 a rank) for ``MP_STEPS`` steps and one MotionLearning-R18 step with
    the RandLayerNorm noise on (B=8, 128x416), against the same global batches at world 1 in this
    process: losses, grad_norm, parameters and running statistics within the tier-1 limits, the
    state equal to the bit on both ranks, K1-K4 at 4/8/4/4 a MonoDepth2 step on each rank and K1, K3
    and K5 in the MotionLearning step. Returns both ranks' launches, summed, and rank 0's MonoDepth2
    record."""
    import tempfile

    import torch

    script = os.path.abspath(__file__)
    address = f"127.0.0.1:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(MP_WORLD)]
        procs = [subprocess.Popen([sys.executable, script, "--multiprocess-rank", str(r), str(MP_WORLD), address,
                                   outs[r]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(MP_WORLD)]
        try:
            logs = [p.communicate(timeout=MP_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        results = [torch.load(o, weights_only=False) if os.path.isfile(o) else {"error": logs[r][-3000:]}
                   for r, o in enumerate(outs)]
    errors = [r["error"] for r in results if "error" in r]
    if errors or any(p.returncode for p in procs):
        emit({"phase": "multiprocess_path", "ok": False, "backend": "gloo", "why_gloo": GLOO_ON_ONE_CARD,
              "errors": errors, "returncodes": [p.returncode for p in procs]})
        raise AssertionError(f"multiprocess_path failed: {errors}")
    t0 = time.perf_counter()
    world1 = _mp_steps(device)  # after the ranks, so that their step times are their own
    world1_s = time.perf_counter() - t0

    rec = {"phase": "multiprocess_path", "backend": "gloo", "why_gloo": GLOO_ON_ONE_CARD, "world": MP_WORLD,
           "device": "cuda:0 (both ranks)", "compute_dtype": "float32 (cuDNN without TF32)",
           "world1_seconds": world1_s}
    per_step = {"warp_bilinear_fwd": 4, "photometric_map_fwd": 8, "warp_bilinear_bwd_coords": 4,
                "photometric_map_bwd": 4, "warp_bilinear_bwd_image": 0}
    launches = dict.fromkeys(per_step, 0)
    for name, batch, hw in (("monodepth2", MP_B, PLANES[0]), ("motion", MP_B, MOTION_HW)):
        if results[0][name]["digest"] != results[1][name]["digest"]:
            raise AssertionError(f"{name}: the state after the steps differs between the ranks")
        for r in range(MP_WORLD):
            if [s["metrics"] for s in results[r][name]["steps"]] != [s["metrics"] for s in results[0][name]["steps"]]:
                raise AssertionError(f"{name}: rank {r}'s metrics differ from rank 0's")
            for s in results[r][name]["steps"]:
                if name == "monodepth2" and s["launches"] != per_step:
                    raise AssertionError(f"rank {r} launched {s['launches']} in a MonoDepth2 step, expected {per_step}")
                if name == "motion" and not (s["launches"]["warp_bilinear_fwd"] >= 1
                                             and s["launches"]["warp_bilinear_bwd_coords"] >= 1
                                             and s["launches"]["warp_bilinear_bwd_image"] >= 1):
                    raise AssertionError(f"rank {r}'s MotionLearning step launched {s['launches']}: no K1, K3 or K5")
                for k, n in s["launches"].items():
                    launches[k] += n
        rec[name] = {
            "global_batch": batch, "hw": list(hw), "steps": len(results[0][name]["steps"]),
            "step_ms_by_rank": [[s["ms"] for s in results[r][name]["steps"]] for r in range(MP_WORLD)],
            "step_ms_world1": [s["ms"] for s in world1[name]["steps"]],
            "collectives_per_step": results[0][name]["steps"][-1]["collectives"],
            "launches_per_step_rank0": results[0][name]["steps"][-1]["launches"],
            "metrics_last": results[0][name]["steps"][-1]["metrics"],
            "metrics_last_world1": world1[name]["steps"][-1]["metrics"],
        }
        agreement, failed = _mp_compare(results[0][name], world1[name])
        rec[name].update(agreement, limits_past=failed)
    rec["launches"] = launches
    emit(rec)
    failed = {name: rec[name]["limits_past"] for name in ("monodepth2", "motion") if rec[name]["limits_past"]}
    if failed:
        raise AssertionError(f"world {MP_WORLD} disagrees with world 1: {failed}")
    return launches, results[0]["monodepth2"]


def phase_nccl_world1_path(device, world2):
    """An NCCL group of world 1 made here: ``projects/Supervised/train_torch.py`` (the ``_cli`` helper,
    one epoch on synthetic 192x640 frames with its evaluation) and ``multiprocess_path``'s MonoDepth2-R18
    steps through the global path (collectives on NCCL), each held against the same run with no group;
    and ``world2`` (``multiprocess_path``'s rank 0) against these steps, the same code at world 2 and at
    world 1. The group is destroyed at the end. Returns the launches of the runs in the group."""
    import datetime
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from simpledepthestimation_tpu_torch.parallel import mesh
    from simpledepthestimation_tpu_torch.utils import comm

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp()
    argv = ["--cfg", os.path.join(root, "projects", "Supervised", "configs", "synthetic_quick.yaml"),
            "TPU.COMPUTE_DTYPE", "float32", "DATASETS.TRAIN.LENGTH", 16, "DATASETS.TEST.LENGTH", 4,
            "SOLVER.MAX_EPOCHS", 1, "TEST.EVAL_PERIOD", 1, "LOG_PERIOD", 1, "DATALOADER.NUM_WORKERS", 4]
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        _cli("Supervised", argv + ["OUTPUT_DIR", os.path.join(tmp, "plain")])
        mono_plain = _mp_steps(device, names=("monodepth2",))["monodepth2"]

        torch.cuda.set_device(device.index or 0)
        comm.init_process_group(f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0, backend="nccl",
                                timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
        try:
            if not (mesh.is_global() and dist.get_backend() == "nccl"):
                raise AssertionError("the NCCL group of world 1 did not put the port on its global path")
            reset_launch_counts()
            mesh.reset_collective_counts()
            _cli("Supervised", argv + ["OUTPUT_DIR", os.path.join(tmp, "nccl")])
            cli_launches, cli_collectives = read_launch_counts(), dict(mesh.collective_counts)
            mono_nccl = _mp_steps(device, names=("monodepth2",))["monodepth2"]
        finally:
            dist.destroy_process_group()
        if mesh.is_global():
            raise AssertionError("the process group outlived the phase")

        run = "Supervised_synthetic_quick"
        rows = {k: _metric_rows(os.path.join(tmp, k, run)) for k in ("plain", "nccl")}
        steps = {k: [r for r in v if "silog_loss" in r] for k, v in rows.items()}
        evals = {k: [r for r in v if "kitti evaluator/abs_rel" in r] for k, v in rows.items()}
        if not steps["plain"] or len(steps["plain"]) != len(steps["nccl"]) or len(evals["nccl"]) != 1:
            raise AssertionError(f"the Supervised runs wrote {len(steps['plain'])} / {len(steps['nccl'])} step rows")
        keys = ("silog_loss", "total_loss", "grad_norm")
        cli_loss_err, cli_norm_err = _metric_errors([{k: r[k] for k in keys} for r in steps["nccl"]],
                                                    [{k: r[k] for k in keys} for r in steps["plain"]])
        # relative above 1, absolute below (an untrained model's d1 may be 0)
        eval_err = max(abs(evals["nccl"][0][k] - evals["plain"][0][k]) / max(abs(evals["plain"][0][k]), 1.0)
                       for k in evals["plain"][0] if k.startswith("kitti evaluator/"))
        cli_failed = _limits_past(cli_loss_err, cli_norm_err) + (["evaluation"] if eval_err > MP_TRAJ_EVAL_RTOL else [])
        if any(cli_launches.values()):
            raise AssertionError(f"the Supervised run launched {cli_launches}")
        step = mono_nccl["steps"][0]
        if step["launches"] != {"warp_bilinear_fwd": 4, "photometric_map_fwd": 8, "warp_bilinear_bwd_coords": 4,
                                "photometric_map_bwd": 4, "warp_bilinear_bwd_image": 0}:
            raise AssertionError(f"the MonoDepth2 step in the NCCL group launched {step['launches']}")
        launches = {k: sum(s["launches"][k] for s in mono_nccl["steps"]) for k in step["launches"]}
        agreement, failed = _mp_compare(mono_nccl, mono_plain)
        same_path, same_path_failed = _mp_compare(world2, mono_nccl, MP_SAME_PATH_GRAD_NORM_RTOL)
        emit({"phase": "nccl_world1_path", "backend": "nccl", "world": 1,
              "supervised_cli": {"steps": len(steps["nccl"]), "loss_rel_err_by_step": cli_loss_err,
                                 "grad_norm_rel_err_by_step": cli_norm_err, "eval_rel_err": eval_err,
                                 "collectives": cli_collectives, "limits_past": cli_failed},
              "monodepth2": {"global_batch": MP_B, "hw": list(PLANES[0]), "steps": len(mono_nccl["steps"]),
                             "step_ms_nccl": [s["ms"] for s in mono_nccl["steps"]],
                             "step_ms_plain": [s["ms"] for s in mono_plain["steps"]],
                             "collectives_per_step": step["collectives"], **agreement, "limits_past": failed},
              "world2_against_this_path": {**same_path, "limits_past": same_path_failed},
              "launches": launches})
        if failed or cli_failed or same_path_failed:
            raise AssertionError(f"the runs in the NCCL group disagree: Supervised {cli_failed}, MonoDepth2 {failed}, "
                                 f"world 2 against them {same_path_failed}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if "--multiprocess-rank" in sys.argv[1:]:  # one rank of multiprocess_path, started by that phase
        i = sys.argv.index("--multiprocess-rank")
        rank, world, address, out_path = sys.argv[i + 1:i + 5]
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return multiprocess_rank(int(rank), int(world), address, out_path)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from simpledepthestimation_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})
    emit(environment_line())

    cuda_lib.load(verbose=True)
    emit({"phase": "build", "sources": [os.path.relpath(s, os.path.dirname(os.path.abspath(__file__)))
                                        for s in cuda_lib.sources()],
          "seconds": cuda_lib.build_seconds, "built_now": cuda_lib.build_seconds is not None})

    flagship = phase_kernels(device)
    if "--kernels-only" in sys.argv[1:]:
        # the kernels' cases and times alone, e.g. of another tree's kernels with this script
        # copied into its root: no main path, so no closing line
        emit({"phase": "done", "kernels_only": True, "seconds": time.perf_counter() - t_start})
        return 0
    waymo = waymo_tree()
    by_path = {"main_path": phase_main_path(device), "train_path": phase_train_path(device),
               "motion_train_path": phase_motion_train_path(device),
               "cli_train_path": phase_cli_train_path(device),
               "motion_cli_train_path": phase_motion_cli_train_path(device),
               "default_trainer_path": phase_default_trainer_path(device),
               "async_vis_path": phase_async_vis_path(device),
               "waymo_cli_train_path": phase_waymo_cli_train_path(device, waymo),
               "waymo_motion_cli_train_path": phase_waymo_motion_cli_train_path(device, waymo)}
    phase_waymo_supervised_cli_train_path(device, waymo)  # launches none of K1-K5 (checked)
    phase_jpeg_agreement(device, waymo)
    phase_predictor_export_path(device)
    # the Supervised family launches none of K1-K5 (each phase checks it)
    for phase in (phase_supervised_train_path, phase_bts_train_path, phase_supervised_cli_train_path):
        phase(device)
    by_path["packnet_train_path"] = phase_packnet_train_path(device)
    by_path["motion_rigid_train_path"] = phase_motion_rigid_train_path(device)
    by_path["report_tools_path"] = phase_report_tools_path(device)
    phase_cpu_agreement(device)
    phase_cpu_agreement_motion(device)
    phase_cpu_agreement_bts(device)
    phase_cpu_agreement_packnet(device)
    phase_cpu_agreement_motion_rigid(device)
    by_path["multiprocess_path"], world2 = phase_multiprocess_path(device)
    by_path["nccl_world1_path"] = phase_nccl_world1_path(device, world2)
    if "--profile" in sys.argv[1:]:
        profile_paths(device)

    csrc = "simpledepthestimation_tpu_torch/csrc/"
    pallas = "simpledepthestimation_tpu/ops/"
    kernels = []
    for key, name, source, replaces, paths in (
        ("warp", "warp_bilinear_fwd", csrc + "warp.cu", pallas + "pallas_warp.py:755",
         ("main_path", "train_path", "motion_train_path", "cli_train_path", "motion_cli_train_path",
          "default_trainer_path", "async_vis_path", "waymo_cli_train_path", "waymo_motion_cli_train_path",
          "packnet_train_path", "motion_rigid_train_path", "multiprocess_path", "nccl_world1_path",
          "report_tools_path")),
        ("photo", "photometric_map_fwd", csrc + "photometric.cu", pallas + "pallas_photometric.py:243",
         ("main_path", "train_path", "cli_train_path", "default_trainer_path", "async_vis_path",
          "waymo_cli_train_path", "packnet_train_path", "multiprocess_path", "nccl_world1_path", "report_tools_path")),
        ("warp_bwd", "warp_bilinear_bwd_coords", csrc + "warp.cu", pallas + "pallas_warp.py:802",
         ("train_path", "motion_train_path", "cli_train_path", "motion_cli_train_path", "default_trainer_path",
          "async_vis_path", "waymo_cli_train_path", "waymo_motion_cli_train_path", "packnet_train_path",
          "motion_rigid_train_path", "multiprocess_path", "nccl_world1_path", "report_tools_path")),
        ("photo_bwd", "photometric_map_bwd", csrc + "photometric.cu", pallas + "pallas_photometric.py:171",
         ("train_path", "cli_train_path", "default_trainer_path", "async_vis_path", "waymo_cli_train_path",
          "packnet_train_path", "multiprocess_path", "nccl_world1_path", "report_tools_path")),
        ("warp_bwd_image", "warp_bilinear_bwd_image", csrc + "warp.cu", pallas + "pallas_warp.py:1119",
         ("motion_train_path", "motion_cli_train_path", "waymo_motion_cli_train_path", "motion_rigid_train_path",
          "multiprocess_path", "report_tools_path")),
    ):
        counts = {path: by_path[path][name] for path in paths}
        if min(counts.values()) < 1:
            raise AssertionError(f"{name} was never launched on a path that runs it: {counts}")
        rec = flagship[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(counts.values()), "launches_by_path": counts,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"],
            **{k: rec.get(k) for k in ("device_ms", "enqueue_us", "library_device_ms", "library_enqueue_us")},
        })
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
