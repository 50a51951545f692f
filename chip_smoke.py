#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels under ``simpledepthestimation_tpu_torch/csrc`` from
source (nvcc, sm_90a), holds each against its plain PyTorch version on the
card, drives the port's main path (MonoDepth2-R18 forward at B=16, 192x640,
N=2, bfloat16 convolutions: depth prediction and the validation-loss pass) and
compares the path with a CPU copy of the model at a small shape. Every phase
prints one JSON line; a failed phase raises, so the exit code is non-zero and
the closing line is not printed. Without a CUDA device it exits non-zero at
once: nothing here falls back to the CPU.

Phases: device, build, kernels, main_path, cpu_agreement (and, with
``--profile``, a torch.profiler breakdown of the main path by kernel). Then one line
``{"kernels": [...]}`` with one entry per kernel at the main path's largest
shape, the card's name and power limit as nvidia-smi prints them, and the
closing line ``{"ok": true, "device": {...}}``.

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


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_batch(seed: int, B: int, H: int, W: int, N: int, device):
    """A training batch from a numpy seed, NCHW, on ``device``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
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
    for dtype, warp_tol, tag in ((torch.float32, F32_TOL, ""), (torch.bfloat16, BF16_WARP_TOL, "_bf16")):
        for h, w in PLANES:
            image, x, y = synthesis_coords(11 + h, NB, h, w, device)
            image = image.to(dtype)
            rec = check_warp(image, x, y, warp_tol, "view_synthesis" + tag, timed=True)
            if (h, w) == PLANES[0] and dtype == torch.float32:
                flagship["warp"] = rec
            # uniform coordinates reaching one whole plane outside on every side
            xu = (rand(NB, h, w) * 3.0 - 1.0) * w
            yu = (rand(NB, h, w) * 3.0 - 1.0) * h
            check_warp(image, xu, yu, warp_tol, "uniform_3x_plane" + tag, timed=True)
        check_warp(rand(2, 3, 37, 83).to(dtype), rand(2, 37, 83) * 100 - 8, rand(2, 37, 83) * 50 - 6,
                   warp_tol, "unaligned" + tag, timed=False)
        check_warp(rand(2, 5, 37, 83).to(dtype), rand(2, 21, 45) * 100 - 8, rand(2, 21, 45) * 50 - 6,
                   warp_tol, "unaligned_other_output_size" + tag, timed=False)

        for h, w in PLANES:
            a, b = rand(2 * NB, 3, h, w), rand(2 * NB, 3, h, w)
            b = 0.8 * a + 0.2 * b  # correlated, as a warped frame is with its target
            rec = check_photo(a.to(dtype), b.to(dtype), F32_TOL, "flagship" + tag, timed=True)
            if (h, w) == PLANES[0] and dtype == torch.float32:
                flagship["photo"] = rec
        check_photo(rand(2, 3, 37, 83).to(dtype), rand(2, 3, 37, 83).to(dtype), F32_TOL,
                    "unaligned" + tag, timed=False)
        check_photo(rand(1, 2, 2, 2).to(dtype), rand(1, 2, 2, 2).to(dtype), F32_TOL,
                    "smallest" + tag, timed=False)
        check_photo(rand(1, 3, 768, 1920).to(dtype), rand(1, 3, 768, 1920).to(dtype), F32_TOL,
                    "large_plane" + tag, timed=True)
    for key in ("warp", "photo"):
        flagship[key]["max_abs_err"] = worst[flagship[key]["kernel"]]
    return flagship


def smoke_cfg(extra=()):
    from simpledepthestimation_tpu_torch.config import get_cfg

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(root, "projects", "MonoDepth2", "configs", "resnet18.yaml"))
    # the ImageNet-pretrained encoder ("18pt") needs a weight file the repository does not hold
    cfg.merge_from_list(["MODEL.DEPTH_NET.ENCODER_NAME", "18", *extra])
    return cfg


def phase_main_path(device):
    import torch

    from simpledepthestimation_tpu_torch.models import build_model
    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    cfg = smoke_cfg()
    B, (H, W), N = int(cfg.SOLVER.IMS_PER_BATCH), PLANES[0], int(cfg.MODEL.POSE_NET.NUM_CONTEXTS)
    if (B, N) != (SMOKE_B, SMOKE_N):
        raise AssertionError(f"config gives B={B}, N={N}; the kernel phase assumed {SMOKE_B}, {SMOKE_N}")
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
    warp_bilinear.launches = 0
    photometric_map.launches = 0
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
    launches = {"warp_bilinear_fwd": warp_bilinear.launches, "photometric_map_fwd": photometric_map.launches}
    emit({
        "phase": "main_path", "model": "MonoDepth2-R18", "batch": B, "hw": [H, W], "contexts": N,
        "compute_dtype": str(cfg.TPU.COMPUTE_DTYPE), "steps": steps, "launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches


def profile_main_path(device, top: int = 12):
    """Optional (``--profile``): where the device time of one steady-state
    ``train=False`` forward and one loss pass goes, by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simpledepthestimation_tpu_torch.models import build_model

    cfg = smoke_cfg()
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    batch = make_batch(100, SMOKE_B, *PLANES[0], SMOKE_N, device)
    for train in (False, True):
        with torch.no_grad():
            for _ in range(3):  # warm-up: cuDNN picks its algorithms
                model(batch, train=train)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(batch, train=train)
                torch.cuda.synchronize()
        # kernel rows only: operator rows repeat the time of the kernels they launch
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows = sorted(rows, key=lambda r: -r[2])
        device_ms = sum(r[2] for r in rows)
        emit({
            "phase": "profile", "call": "loss_pass" if train else "depth_pred",
            "device_busy_ms": device_ms,
            "device_kernel_launches": sum(r[1] for r in rows),
            "top": [{"name": k[:80], "count": c, "ms": ms} for k, c, ms in rows[:top]],
        })


def phase_cpu_agreement(device):
    import torch

    from simpledepthestimation_tpu_torch.models import build_model

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
    launches = phase_main_path(device)
    phase_cpu_agreement(device)
    if "--profile" in sys.argv[1:]:
        profile_main_path(device)

    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")
    csrc = "simpledepthestimation_tpu_torch/csrc/"
    pallas = "simpledepthestimation_tpu/ops/"
    kernels = []
    for key, name, source, replaces in (
        ("warp", "warp_bilinear_fwd", csrc + "warp.cu", pallas + "pallas_warp.py:755"),
        ("photo", "photometric_map_fwd", csrc + "photometric.cu", pallas + "pallas_photometric.py:243"),
    ):
        rec = flagship[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
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
