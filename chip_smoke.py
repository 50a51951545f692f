#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels under ``simpledepthestimation_tpu_torch/csrc`` from
source (nvcc, sm_90a), holds each against its plain PyTorch version on the
card, drives the port's main paths at B=16, 192x640, N=2 with bfloat16
convolutions (MonoDepth2-R18 forward: depth prediction and the validation-loss
pass; and the train step: loss, backward through the kernels, Adam with
depth/pose groups and the per-step schedule) and compares forward, gradients
and one update with a CPU copy of the model at a small shape. Every phase
prints one JSON line; a failed phase raises, so the exit code is non-zero and
the closing line is not printed. Without a CUDA device it exits non-zero at
once: nothing here falls back to the CPU.

Phases: device, build, kernels, main_path, train_path, cpu_agreement (and, with
``--profile``, a torch.profiler breakdown of the forward calls and of the train
step by kernel). Then one line ``{"kernels": [...]}`` with one entry per kernel
at the main path's largest shape, the card's name and power limit as nvidia-smi
prints them, and the closing line ``{"ok": true, "device": {...}}``.

Times are CUDA-event times over repeated launches after a warm-up. ``bound_ms``
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
BF16_VJP_RTOL = 2.0**-7
# Parameter gradients, card vs CPU, per tensor relative to its largest entry: a whole backward
# pass in another order, and a bias or norm gradient is a sum of thousands of signed terms that
# cancel (worst measured: 1.4e-3 at the encoder's bn1.bias, while the global norm agreed to 1.2e-5)
GRAD_AGREE_RTOL = 5e-3
GRAD_NORM_RTOL = 1e-4
TRAIN_FIXED_STEPS, TRAIN_FRESH_STEPS = 8, 3

# The pose net's first convolution has 16 channels and feeds a GroupNorm of 16 groups, which
# subtracts each channel's mean: the bias's gradient is zero but for rounding, and may be 0.0.
ZERO_GRADIENT_BY_CONSTRUCTION = {"pose_net.conv1.0.bias"}

PLANES = [(192, 640), (96, 320), (48, 160), (24, 80)]
SMOKE_B, SMOKE_N = 16, 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def synthesis_coords(seed: int, B: int, h: int, w: int, device):
    """Pixel coordinates of a real view synthesis: seeded depth and pose."""
    import numpy as np
    import torch

    from simpledepthestimation_tpu_torch.geometry.camera import view_synthesis
    from simpledepthestimation_tpu_torch.geometry.pose import pose_vec2mat

    rng = np.random.RandomState(seed)
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
        rec["ms"] = cuda_ms(lambda: warp_bilinear(image, x, y))
        rec["plain_ms"] = cuda_ms(lambda: warp_bilinear_plain(image, x, y), iters=3, warmup=1)
        rec["library_ms"] = cuda_ms(
            lambda: F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        )
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
        rec["ms"] = cuda_ms(lambda: photometric_map(a, b, 0.85, 1e-4, 9e-4))
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
        rec["ms"] = cuda_ms(lambda: warp_coord_grad(image, x, y, ct))
        rec["plain_ms"] = cuda_ms(lambda: warp_coord_grad_plain(image, x, y, ct), iters=3, warmup=1)
        # one PyTorch call for the same function: grid_sample's backward with respect
        # to the grid (its gradient is per unit of normalised coordinate: a constant
        # factor (W-1)/2, (H-1)/2 away, which costs nothing next to the call)
        grid = torch.stack([2.0 * x / (W - 1.0) - 1.0, 2.0 * y / (H - 1.0) - 1.0], dim=-1)
        grid = grid.to(image.dtype).requires_grad_()
        sampled = F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        rec["library_ms"] = cuda_ms(lambda: torch.autograd.grad(sampled, grid, ct, retain_graph=True))
    rec["launches"] = warp_bilinear.bwd_launches - before
    emit(rec)
    if not (err <= tol * scale):
        raise AssertionError(f"warp_bilinear_bwd_coords disagrees with its plain version: {rec}")
    if dx.shape != x.shape or dx.dtype != torch.float32 or not (torch.isfinite(dx).all() and torch.isfinite(dy).all()):
        raise AssertionError(f"warp_bilinear_bwd_coords gave a wrong shape, dtype or non-finite values: {rec}")
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
        rec["ms"] = cuda_ms(lambda: photometric_vjp(a, b, g, 0.85, 1e-4, 9e-4, need_a=True, need_b=both))
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


def phase_kernels(device):
    import numpy as np
    import torch

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

        for h, w in PLANES:
            a, b = rand(2 * NB, 3, h, w), rand(2 * NB, 3, h, w)
            b = 0.8 * a + 0.2 * b  # correlated, as a warped frame is with its target
            g = rand(2 * NB, 1, h, w)
            rec = check_photo(a.to(dtype), b.to(dtype), F32_TOL, "flagship" + tag, timed=True)
            rec_bwd = check_photo_bwd(a.to(dtype), b.to(dtype), g, vjp_tol, "flagship" + tag, timed=True, both=False)
            check_photo_bwd(a.to(dtype), b.to(dtype), g, vjp_tol, "flagship" + tag, timed=True, both=True)
            if (h, w) == PLANES[0] and dtype == torch.float32:
                flagship["photo"], flagship["photo_bwd"] = rec, rec_bwd
        for shape, label, timed in (((2, 3, 37, 83), "unaligned", False), ((1, 2, 2, 2), "smallest", False),
                                    ((1, 3, 768, 1920), "large_plane", True)):
            a, b = rand(*shape).to(dtype), rand(*shape).to(dtype)
            check_photo(a, b, F32_TOL, label + tag, timed=timed)
            g = rand(shape[0], 1, 1, 1).expand(shape[0], 1, *shape[2:])  # expanded, as above
            check_photo_bwd(a, b, g, vjp_tol, label + tag, timed=timed, both=True)

    # all four kernels in a row, at the second plane
    h, w = PLANES[1]
    image, x, y = synthesis_coords(5, 4, h, w, device)
    _check_kernel_chain(image, x, y, 0.8 * image + 0.2 * rand(4, 3, h, w), rand(4, 1, h, w))
    for rec in flagship.values():
        rec["max_abs_err"] = worst[rec["kernel"]]
    return flagship


def smoke_cfg(extra=()):
    from simpledepthestimation_tpu_torch.config import get_cfg

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(root, "projects", "MonoDepth2", "configs", "resnet18.yaml"))
    # the ImageNet-pretrained encoder ("18pt") needs a weight file the repository does not hold
    cfg.merge_from_list(["MODEL.DEPTH_NET.ENCODER_NAME", "18", *extra])
    return cfg


def reset_launch_counts() -> None:
    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    warp_bilinear.launches = warp_bilinear.bwd_launches = 0
    photometric_map.launches = photometric_map.bwd_launches = 0


def read_launch_counts() -> dict:
    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    return {
        "warp_bilinear_fwd": warp_bilinear.launches, "photometric_map_fwd": photometric_map.launches,
        "warp_bilinear_bwd_coords": warp_bilinear.bwd_launches, "photometric_map_bwd": photometric_map.bwd_launches,
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
        if (d1, d2) != (4, 4):
            raise AssertionError(f"train=True forward launched K1 {d1}x and K2 {d2}x, expected 4 and 4")
        vals = {k: v.item() for k, v in losses.items()}
        if set(vals) != {"rec_loss", "smooth_loss"} or not all(v == v and abs(v) < 1e6 for v in vals.values()):
            raise AssertionError(f"loss dict is wrong or not finite: {vals}")
        steps.append({"depth_min": lo, "depth_max": hi, "eval_ms": eval_ms, "loss_pass_ms": train_ms, **vals})
    launches = read_launch_counts()
    if launches["warp_bilinear_bwd_coords"] or launches["photometric_map_bwd"]:
        raise AssertionError(f"a forward under no_grad launched a backward kernel: {launches}")
    emit({
        "phase": "main_path", "model": "MonoDepth2-R18", "batch": B, "hw": [H, W], "contexts": N,
        "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "steps": steps, "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches


def phase_train_path(device):
    """The train step through the port's entry points, full width, on the card."""
    import torch

    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step

    cfg = smoke_cfg()
    B, (H, W), N = int(cfg.SOLVER.IMS_PER_BATCH), PLANES[0], int(cfg.MODEL.POSE_NET.NUM_CONTEXTS)
    steps_per_epoch = 4  # so that the rate drops at step 60 = LR_STEPS 15 epochs: not reached here
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), steps_per_epoch=steps_per_epoch)
    if next(state.model.parameters()).device.type != "cuda":
        raise AssertionError("create_train_state did not place the model on the card")
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP))
    fixed = make_batch(300, B, H, W, N, device, smooth=True)
    fresh = [make_batch(301 + i, B, H, W, N, device, smooth=True) for i in range(TRAIN_FRESH_STEPS)]
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}

    reset_launch_counts()
    records, metrics_dev = [], []
    for i, batch in enumerate([fixed] * TRAIN_FIXED_STEPS + fresh):
        counts = read_launch_counts()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        metrics = step(batch)
        stop.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3  # the step returns without waiting for the card
        torch.cuda.synchronize()
        per_step = {k: v - counts[k] for k, v in read_launch_counts().items()}
        if set(per_step.values()) != {4}:
            raise AssertionError(f"train step {i} launched {per_step}, expected 4 of each kernel (one per scale)")
        if not all(isinstance(v, torch.Tensor) and v.device.type == "cuda" and v.dim() == 0 for v in metrics.values()):
            raise AssertionError("the step's metrics are not 0-d tensors on the card")
        if i == 0:
            no_grad = [k for k, p in state.model.named_parameters()
                       if p.grad is None or not (bool((p.grad != 0).any()) or k in ZERO_GRADIENT_BY_CONSTRUCTION)]
            if no_grad:
                raise AssertionError(f"{len(no_grad)} parameters received no gradient, e.g. {no_grad[:5]}")
        metrics_dev.append(metrics)
        records.append({"step_ms": start.elapsed_time(stop), "enqueue_ms": enqueue_ms,
                        "batch": "fixed" if i < TRAIN_FIXED_STEPS else "fresh"})
    launches = read_launch_counts()
    for rec, metrics in zip(records, metrics_dev):
        rec.update({k: v.item() for k, v in metrics.items()})
        if set(metrics) != {"total_loss", "grad_norm", "rec_loss", "smooth_loss"}:
            raise AssertionError(f"unexpected metrics {sorted(metrics)}")
        if not all(v == v and abs(v) < 1e6 for k, v in rec.items() if isinstance(v, float)):
            raise AssertionError(f"a metric is not finite: {rec}")
        if not rec["grad_norm"] > 0:
            raise AssertionError(f"grad_norm is not positive: {rec}")
    first, last = records[0]["total_loss"], records[TRAIN_FIXED_STEPS - 1]["total_loss"]
    if not last < first:
        raise AssertionError(f"total_loss on the fixed batch did not fall: step 1 {first}, step {TRAIN_FIXED_STEPS} {last}")
    unchanged = [k for k, p in state.model.named_parameters()
                 if torch.equal(p.detach(), before[k]) and k not in ZERO_GRADIENT_BY_CONSTRUCTION]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} parameters did not change, e.g. {unchanged[:5]}")
    n_steps = TRAIN_FIXED_STEPS + TRAIN_FRESH_STEPS
    lrs = state.scheduler.get_last_lr()
    if state.step != n_steps or state.scheduler.last_step != n_steps or lrs != [float(cfg.SOLVER.DEPTH_LR), float(cfg.SOLVER.POSE_LR)]:
        raise AssertionError(f"step count or rate is off: step {state.step}, lr {lrs}")
    if any(p.dtype != torch.float32 for p in state.model.parameters()):
        raise AssertionError("a parameter left float32")

    # steady state, the way a training loop runs it: steps back to back, one wait at the end
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 10
    for i in range(n_timed):
        step(fresh[i % len(fresh)])
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) * 1e3 / n_timed

    depth = make_eval_step(state)(fixed)
    lo, hi = depth.min().item(), depth.max().item()
    if depth.shape != (B, 1, H, W) or not (torch.isfinite(depth).all() and lo > 0.0 and hi <= 80.0 * (1 + 1e-6)):
        raise AssertionError(f"depth_pred after training is off: shape {tuple(depth.shape)}, min {lo}, max {hi}")
    emit({
        "phase": "train_path", "model": "MonoDepth2-R18", "batch": B, "hw": [H, W], "contexts": N,
        "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "optimizer": str(cfg.SOLVER.OPT), "lr": lrs,
        "steps": records, "launches": launches, "launches_per_step": 4,
        "steady_step_ms": steady_ms, "steady_images_per_s": B / steady_ms * 1e3,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "depth_after": [lo, hi],
    })
    return launches


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
    })


def profile_paths(device, top: int = 14):
    """Optional (``--profile``): where the device time of one steady-state
    ``train=False`` forward, one loss pass and one train step goes, by kernel
    name, and how much of the wall time the device is busy."""
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


def phase_cpu_agreement(device):
    import torch

    from simpledepthestimation_tpu_torch.models import build_model
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_cfg(["TPU.COMPUTE_DTYPE", "float32"])
    on_card = build_model(cfg, generator=torch.Generator().manual_seed(1))
    on_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    on_cpu.load_state_dict(on_card.state_dict())
    batch_cpu = make_batch(200, 2, 64, 256, SMOKE_N, "cpu")
    batch_card = {k: v.to(device) for k, v in batch_cpu.items()}
    with torch.no_grad():
        d_card = on_card(batch_card, train=False)["depth_pred"].cpu()
        d_cpu = on_cpu(batch_cpu, train=False)["depth_pred"]
        l_card = {k: v.item() for k, v in on_card(batch_card, train=True).items()}
        l_cpu = {k: v.item() for k, v in on_cpu(batch_cpu, train=True).items()}
    depth_err = ((d_card - d_cpu).abs() / d_cpu.abs().clamp_min(1.0)).max().item()
    loss_err = {k: abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu}
    emit({"phase": "cpu_agreement", "shape": [2, 64, 256], "rtol": AGREE_RTOL,
          "depth_rel_err": depth_err, "loss_rel_err": loss_err, "losses_card": l_card, "losses_cpu": l_cpu})
    if set(l_card) != set(l_cpu) or depth_err > AGREE_RTOL or any(e > AGREE_RTOL for e in loss_err.values()):
        raise AssertionError("the card's forward disagrees with the CPU copy of the model")

    # one float32 train step on the card (kernels) and on the CPU copy (plain versions)
    card = create_train_state(cfg, generator=torch.Generator().manual_seed(3), steps_per_epoch=4)
    cpu = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(4), steps_per_epoch=4)
    cpu.model.load_state_dict(card.model.state_dict())
    start = {k: p.detach().cpu().clone() for k, p in card.model.named_parameters()}
    batch_cpu = make_batch(201, 2, 64, 256, SMOKE_N, "cpu", smooth=True)
    m_card = {k: v.item() for k, v in make_train_step(card)({k: v.to(device) for k, v in batch_cpu.items()}).items()}
    m_cpu = {k: v.item() for k, v in make_train_step(cpu)(batch_cpu).items()}
    loss_err = abs(m_card["total_loss"] - m_cpu["total_loss"]) / abs(m_cpu["total_loss"])
    norm_err = abs(m_card["grad_norm"] - m_cpu["grad_norm"]) / abs(m_cpu["grad_norm"])
    g_cpu = {k: p.grad for k, p in cpu.model.named_parameters()}
    g_card = {k: p.grad.cpu() for k, p in card.model.named_parameters()}
    # a gradient that is zero but for rounding is held against the largest gradient instead of its own
    g_max = max(g.abs().max().item() for g in g_cpu.values())
    grad_err = {k: (g_card[k] - g_cpu[k]).abs().max().item()
                / (g_max if k in ZERO_GRADIENT_BY_CONSTRUCTION else g_cpu[k].abs().max().item())
                for k in g_cpu}
    worst = max(grad_err, key=grad_err.get)
    # after the update: Adam's first step moves every parameter by the rate times
    # g/(|g| + eps), so where |g| is rounding noise the two sides may move apart by
    # up to twice the rate; elsewhere they agree. Held as a norm over all parameters.
    lr = float(cfg.SOLVER.DEPTH_LR)
    p_card = torch.cat([p.detach().cpu().flatten() for p in card.model.parameters()]).double()
    p_cpu = torch.cat([p.detach().flatten() for p in cpu.model.parameters()]).double()
    p_start = torch.cat([start[k].flatten() for k, _ in card.model.named_parameters()]).double()
    update_err = ((p_card - p_cpu).norm() / (p_cpu - p_start).norm()).item()
    max_apart = (p_card - p_cpu).abs().max().item()
    emit({"phase": "cpu_agreement_train_step", "shape": [2, 64, 256], "loss_rel_err": loss_err,
          "grad_norm_rel_err": norm_err, "worst_grad": worst, "worst_grad_rel_err": grad_err[worst],
          "grad_rtol": GRAD_AGREE_RTOL, "update_rel_l2_err": update_err, "update_max_apart": max_apart, "lr": lr,
          "metrics_card": m_card, "metrics_cpu": m_cpu})
    if loss_err > AGREE_RTOL or norm_err > GRAD_NORM_RTOL or grad_err[worst] > GRAD_AGREE_RTOL:
        raise AssertionError("the card's loss or parameter gradients disagree with the CPU copy of the model")
    if not (m_cpu["grad_norm"] > 0 and all(g.abs().max().item() > 0 for k, g in g_cpu.items()
                                           if k not in ZERO_GRADIENT_BY_CONSTRUCTION)):
        raise AssertionError("a gradient of the CPU copy is identically zero: the comparison says nothing")
    if update_err > 5e-2 or max_apart > 2.5 * lr:
        raise AssertionError("the parameters after one update disagree with the CPU copy of the model")


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
    by_path = {"main_path": phase_main_path(device), "train_path": phase_train_path(device)}
    phase_cpu_agreement(device)
    if "--profile" in sys.argv[1:]:
        profile_paths(device)

    csrc = "simpledepthestimation_tpu_torch/csrc/"
    pallas = "simpledepthestimation_tpu/ops/"
    kernels = []
    for key, name, source, replaces, paths in (
        ("warp", "warp_bilinear_fwd", csrc + "warp.cu", pallas + "pallas_warp.py:755", ("main_path", "train_path")),
        ("photo", "photometric_map_fwd", csrc + "photometric.cu", pallas + "pallas_photometric.py:243",
         ("main_path", "train_path")),
        ("warp_bwd", "warp_bilinear_bwd_coords", csrc + "warp.cu", pallas + "pallas_warp.py:802", ("train_path",)),
        ("photo_bwd", "photometric_map_bwd", csrc + "photometric.cu", pallas + "pallas_photometric.py:171",
         ("train_path",)),
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
        })
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
