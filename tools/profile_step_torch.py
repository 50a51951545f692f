#!/usr/bin/env python
"""Split the MonoDepth2 train step on the PyTorch/CUDA port into what its
parts cost: the full step and four variants with a part of the loss or of the
model left out (no SSIM, no automask, no smoothness, the depth net alone under
the supervised loss), at B=16, 192x640, bfloat16 convolutions.

The twin of ``profile_step.py`` (which drives the JAX package): the same
variants of the flagship config (``bench_models_torch.flagship_cfg``), the same
seeded batch, and the same timing: 3 warm steps, then 10 steps between two
waits for the card. With ``LOSS.SSIM_WEIGHT`` 0 the photometric map is the
plain L1 mean, so the no-ssim variant launches neither of the map's kernels.
It runs on the CUDA card; ``--device cpu`` runs it on the CPU in float32.

Usage:
  python tools/profile_step_torch.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools.bench_models_torch import build_step, compute_dtype, flagship_batch, flagship_cfg  # noqa: E402

B, H, W = 16, 192, 640
WARM_STEPS = 3
STEPS = 10


def variants(dtype: str):
    """{name: cfg} of the five variants, in the JAX tool's order."""
    out = {"full (ssim+automask+min)": flagship_cfg(dtype)}
    cfg = flagship_cfg(dtype)
    cfg.LOSS.SSIM_WEIGHT = 0.0
    out["no-ssim"] = cfg
    cfg = flagship_cfg(dtype)
    cfg.LOSS.AUTOMASK = False
    out["no-automask"] = cfg
    cfg = flagship_cfg(dtype)
    cfg.LOSS.SMOOTHNESS_WEIGHT = 0.0
    out["no-smooth"] = cfg
    cfg = flagship_cfg(dtype)
    cfg.MODEL.META_ARCHITECTURE = "SupDepthModel"
    out["supervised-only (nets minus pose/warp)"] = cfg
    return out


def supervised_batch(batch, B, H, W):
    """The supervised-only variant's batch: the flagship's frames and flips and a
    seeded depth map of 1-60 m."""
    depth = np.random.RandomState(0).uniform(1, 60, (B, H, W, 1)).astype(np.float32)
    depth = torch.from_numpy(np.ascontiguousarray(depth.transpose(0, 3, 1, 2))).to(batch["img"].device)
    return {"img": batch["img"], "flip": batch["flip"], "depth": depth}


def time_step(cfg, batch, device, steps=STEPS, warm_steps=WARM_STEPS):
    """Seconds per step: ``warm_steps`` steps and a wait, then ``steps`` steps
    between two waits for the card."""
    _, step = build_step(cfg, device)
    for _ in range(warm_steps):
        m = step(batch)
    float(m["total_loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(batch)
    float(m["total_loss"])
    return (time.perf_counter() - t0) / steps


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device to run on (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None, steps=STEPS, warm_steps=WARM_STEPS):
    """Time every variant; prints one line each and returns {name: seconds a step}."""
    from simpledepthestimation_tpu_torch.models.build import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    batch = flagship_batch(B, H, W, device=device)
    out = {}
    for name, cfg in variants(compute_dtype(device)).items():
        dt = time_step(cfg, supervised_batch(batch, B, H, W) if name.startswith("supervised") else batch, device,
                       steps=steps, warm_steps=warm_steps)
        out[name] = dt
        print(f"{name:42s} {dt * 1000:8.1f} ms/step   {B / dt:7.1f} img/s", flush=True)
    return out


if __name__ == "__main__":
    main()
