"""The one generator of training traffic: seeded batches of smooth frames.

A traffic mix is a JSON file beside this one (``<mix>.json``) of parameters:
the batch, the frame size, the number of contexts, the pool of distinct
batches, the frames' grain, the contexts' shifts and noise, the share of
mirrored samples, the intrinsics as fractions of the frame, the images of an
epoch (which sets where the learning-rate schedule's milestones fall), and
the steps of warm-up and of the traced stretches.

Frames are low-frequency random images (a coarse random grid, one value per
``cell`` pixels, interpolated bilinearly) and each context is the target
shifted sideways by a few pixels plus a little noise (a pan of the camera), so
that both nets get a gradient (on white noise the unwarped context wins the
automask's minimum everywhere and the warp gets none). The driver starts the
pose head at that pan (``drivers.train.pose_head_start``: its rotation about
the vertical axis, shift / fx), with its seeded kernel scaled down: the
warped context then wins the minimum at nearly every pixel, as once the pose
net has learnt the motion. With the seeded head alone the pose is random, the
warped context wins at few pixels, and the comparison's readings swing from
seed to seed (``PERF.md``). The batch dict is the one the training loader
hands over: float32 NCHW ``img``,
``img_orig`` [B,3,H,W], ``ctx_img``, ``ctx_img_orig`` [B,N,3,H,W],
``intrinsics`` [B,3,3] and a boolean ``flip`` [B]. Each batch is drawn on the
device from its own generator and kept in page-locked host memory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import torch

from core.weights import generator

TRAFFIC_STREAM = 0x7AFF_0000  # + the batch's index in the pool


def load(name: str) -> Dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.json")) as f:
        return json.load(f)


def smooth_frames(gen: torch.Generator, B: int, H: int, W: int, cell: int, device) -> torch.Tensor:
    """[B,3,H,W] float32 in [0, 1): a [B,3,H/cell+2,W/cell+2] uniform grid
    interpolated bilinearly, pixel (y, x) at grid point (y/cell, x/cell)."""
    low = torch.rand(B, 3, H // cell + 2, W // cell + 2, generator=gen, device=device)
    ys = torch.arange(H, device=device, dtype=torch.float64) / cell
    xs = torch.arange(W, device=device, dtype=torch.float64) / cell
    y0, x0 = ys.long(), xs.long()
    fy = (ys - y0).float()[:, None]
    fx = (xs - x0).float()[None, :]
    rows0, rows1 = low[:, :, y0], low[:, :, y0 + 1]
    top = rows0[..., x0] * (1 - fx) + rows0[..., x0 + 1] * fx
    bot = rows1[..., x0] * (1 - fx) + rows1[..., x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def context_shifts(mix: Dict) -> List[int]:
    """Each context's sideways shift from the target in pixels: +shift,
    −shift, then one pixel more for each further pair."""
    return [(-1) ** j * (mix["shift"] + j // 2) for j in range(mix["contexts"])]


def make_batch(mix: Dict, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """Batch ``index`` of the pool of ``mix`` for ``seed``, on ``device``."""
    B, H, W, N = mix["batch"], mix["height"], mix["width"], mix["contexts"]
    gen = generator(seed, TRAFFIC_STREAM + index, device)
    img = smooth_frames(gen, B, H, W, mix["cell"], device)
    ctx = torch.stack([torch.roll(img, s, dims=3) for s in context_shifts(mix)], dim=1)
    ctx = ctx + mix["context_noise"] * torch.rand(ctx.shape, generator=gen, device=device)
    k = mix["intrinsics"]
    K = torch.tensor([[k["fx"] * W, 0.0, k["cx"] * W], [0.0, k["fy"] * H, k["cy"] * H], [0.0, 0.0, 1.0]],
                     device=device).expand(B, 3, 3)
    flip = torch.rand(B, generator=gen, device=device) < mix["flip_share"]
    return {"img": img, "img_orig": img.clone(), "ctx_img": ctx, "ctx_img_orig": ctx.clone(),
            "intrinsics": K.contiguous(), "flip": flip}


def make_pool(mix: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``mix["pool"]`` distinct batches in host memory, page-locked when
    ``device`` is a CUDA device."""
    pinned = torch.device(device).type == "cuda"
    pool = []
    for i in range(mix["pool"]):
        batch = make_batch(mix, seed, i, device)
        host = {}
        for key, value in batch.items():
            host[key] = torch.empty(value.shape, dtype=value.dtype, pin_memory=pinned)
            host[key].copy_(value)
        pool.append(host)
    return pool


def steps_per_epoch(mix: Dict) -> int:
    return max(1, mix["epoch_images"] // mix["batch"])
