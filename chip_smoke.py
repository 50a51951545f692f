#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels under ``simpledepthestimation_tpu_torch/csrc`` from
source (nvcc, sm_90a), holds each against its plain PyTorch version on the
card, drives the port's main paths with bfloat16 convolutions (MonoDepth2-R18
at B=16, 192x640, N=2: depth prediction, the validation-loss pass and the train
step; MotionLearning-R18 at B=16, 128x416: the train step with the noise ramp
and the motion burn-in at their ends) and compares forward, gradients and one
update of each model with a CPU copy at a small shape. Every phase
prints one JSON line; a failed phase raises, so the exit code is non-zero and
the closing line is not printed. Without a CUDA device it exits non-zero at
once: nothing here falls back to the CPU.

Both models are the shipped ``projects/{MonoDepth2,MotionLearning}/configs/resnet18.yaml``
as they stand (encoder ``"18pt"``): each train phase prints one ``warm_start``
line with the weight file the ImageNet warm start found (``null``: none in
reach, the encoder keeps its seeded weights, and the port's warning about it
goes to standard error).

Phases: device, build, kernels, main_path, train_path, motion_train_path,
cpu_agreement (float32, then ``cpu_agreement_bf16``: the loss pass and depth in
bfloat16 against the CPU copy), cpu_agreement_train_step, cpu_agreement_motion_train_step (and,
with ``--profile``, a torch.profiler breakdown of the forward calls and of both
train steps by kernel). Then one line ``{"kernels": [...]}`` with one entry per kernel
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
SMOKE_B, SMOKE_N = 16, 2
MOTION_HW = (128, 416)  # projects/MotionLearning/configs/Base.yaml: Resize IMG_H, IMG_W


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_warm_start(model: str, cfg, state) -> None:
    """One line per model: its encoder name and the weight file its warm start
    found (``None``: the encoder keeps its seeded weights; the port's logger
    says so on standard error at each state made)."""
    name = str(cfg.MODEL.DEPTH_NET.ENCODER_NAME)
    emit({"phase": "warm_start", "model": model, "encoder_name": name, "weights_file": state.pretrained_weights})
    if not name.endswith("pt"):
        raise AssertionError(f"the shipped config names no ImageNet-pretrained encoder: {name}")


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


def _agree_train_step(phase, cfg, batch_cpu, device, grad_clip=0.0, schedule_fn=None):
    """One float32 train step on the card (kernels, cuDNN without TF32) and on a
    CPU copy of the same weights (plain versions): every loss, the global
    gradient norm, each parameter's gradient and the parameters after the update.
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
    worst = max(grad_err, key=grad_err.get)
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
          "update_rel_l2_err": update_err, "update_max_apart": max_apart, "lr": lr,
          "launches_on_card": launched, "metrics_card": m_card, "metrics_cpu": m_cpu})
    if max(loss_err.values()) > AGREE_RTOL or norm_err > GRAD_NORM_RTOL or grad_err[worst] > GRAD_AGREE_RTOL:
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


def _profile(fn, label: str, top: int, wall_iters: int = 10):
    """Device time of one call of ``fn`` by kernel name, beside its wall time."""
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: operator rows repeat the time of the kernels they launch
    # (and not the optimizer's annotation range "Optimizer.step#Adam.step", which spans its kernels)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.startswith("Optimizer.")]
    rows = sorted(rows, key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    emit({
        "phase": "profile", "call": label, "wall_ms": wall_ms, "device_busy_ms": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "device_kernel_launches": sum(r[1] for r in rows),
        "top": [{"name": k[:80], "count": c, "ms": ms} for k, c, ms in rows[:top]],
        "hand_written": [{"name": k[:80], "count": c, "ms": ms} for k, c, ms in rows
                         if "warp_bilinear" in k or "photometric_map" in k],
    })


def profile_paths(device, top: int = 14):
    """Optional (``--profile``): where the device time of one steady-state
    ``train=False`` forward, one loss pass and one train step of MonoDepth2, and
    one MotionLearning train step goes, by kernel name, and how much of the wall
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


def main() -> int:
    import torch

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
    by_path = {"main_path": phase_main_path(device), "train_path": phase_train_path(device),
               "motion_train_path": phase_motion_train_path(device)}
    phase_cpu_agreement(device)
    phase_cpu_agreement_motion(device)
    if "--profile" in sys.argv[1:]:
        profile_paths(device)

    csrc = "simpledepthestimation_tpu_torch/csrc/"
    pallas = "simpledepthestimation_tpu/ops/"
    kernels = []
    for key, name, source, replaces, paths in (
        ("warp", "warp_bilinear_fwd", csrc + "warp.cu", pallas + "pallas_warp.py:755",
         ("main_path", "train_path", "motion_train_path")),
        ("photo", "photometric_map_fwd", csrc + "photometric.cu", pallas + "pallas_photometric.py:243",
         ("main_path", "train_path")),
        ("warp_bwd", "warp_bilinear_bwd_coords", csrc + "warp.cu", pallas + "pallas_warp.py:802",
         ("train_path", "motion_train_path")),
        ("photo_bwd", "photometric_map_bwd", csrc + "photometric.cu", pallas + "pallas_photometric.py:171",
         ("train_path",)),
        ("warp_bwd_image", "warp_bilinear_bwd_image", csrc + "warp.cu", pallas + "pallas_warp.py:1119",
         ("motion_train_path",)),
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
