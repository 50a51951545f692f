#!/usr/bin/env python
"""Train-step throughput of each model family on the PyTorch/CUDA port: the
full step (forward, backward, optimizer update) at each family's training
shape, images per second per card.

The twin of ``bench_models.py`` (which drives the JAX package): the same five
families, shapes, batch sizes and per-case options, the same seeded batch
(laid out NCHW), and the same timing protocol: 5 warm steps, then 6 chunks of
5 steps, each chunk ended by reading the loss on the host. It runs on the CUDA
card in bfloat16 convolutions; ``--device cpu`` runs it on the CPU in float32.
The state comes from ``parallel.create_train_state``, so an encoder that asks
for ImageNet weights (BTS-R50's ``resnet50_bts``) gets them where a local file
is in reach and otherwise keeps its seeded weights; a line before each
family's result says which.

Also the shared cases of the other report tools (``profile_step_torch.py``,
``trace_step_torch.py``): ``CASES``, ``make_case``, and the flagship
MonoDepth2-R18 config and batch (``flagship_cfg``, ``flagship_batch``).

Usage:
  python tools/bench_models_torch.py [--family NAME] [--sweep B1,B2] [--device cpu] [KEY VALUE ...]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CASES = [
    # (name, meta_arch, depth_net keys, pose, B, H, W, case_opts)
    # Supervised Base.yaml crops to 352x704 and trains IMS_PER_BATCH 16;
    # bts_r50.yaml trains 8 at the same crop, here with TPU.REMAT as in the JAX tool.
    ("Supervised-R18", "SupDepthModel", {"NAME": "DepthResNet", "ENCODER_NAME": "18"}, False, 16, 352, 704, ()),
    ("BTS-R50", "SupDepthModel", {"NAME": "BtsModel", "ENCODER_NAME": "resnet50_bts"}, False, 8, 352, 704,
     ("TPU.REMAT", "True")),
    ("MonoDepth2-R18", "MonoDepth2Model", {"NAME": "DepthResNet", "ENCODER_NAME": "18"}, True, 48, 192, 640, ()),
    # packnet_1a.yaml trains 192x640 B=8; MotionLearning Base.yaml trains 128x416 B=16
    ("PackNet-1A", "MonoDepth2Model", {"NAME": "PackNet01", "VERSION": "1A"}, True, 8, 192, 640, ()),
    ("MotionLearning-R18", "MotionLearningModel",
     {"NAME": "GoogleResNet", "ENCODER_NAME": "18", "NORM": "randLN", "NOISE_STDDEV": 0.5,
      "RAMPUP_ITERS": 100, "UPSAMPLE_DEPTH": False, "LEARN_SCALE": False},
     "motion", 16, 128, 416, ()),
]

WARM_STEPS = 5
CHUNKS = 6
CHUNK_STEPS = 5


def _on_device(batch, device):
    """numpy NHWC (or [B,N,H,W,C]) batch → the port's NCHW tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim == 4:
            v = v.transpose(0, 3, 1, 2)
        elif v.ndim == 5:
            v = v.transpose(0, 1, 4, 2, 3)
        out[k] = torch.from_numpy(v.copy()).to(device)  # a C-contiguous copy, 0-d arrays kept 0-d
    return out


def compute_dtype(device) -> str:
    """bfloat16 convolutions on the card, float32 on the CPU."""
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def make_case(meta, dn, pose, B, H, W, opts=(), device="cuda"):
    """(cfg, batch) of a family at a given shape: the JAX tool's config and its
    seeded batch, on ``device`` in the port's layout (NCHW; contexts
    [B,N,3,H,W]). ``opts`` is a flat KEY VALUE list merged first, as there."""
    from simpledepthestimation_tpu_torch.config import get_cfg

    cfg = get_cfg()
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.MODEL.META_ARCHITECTURE = meta
    for k, v in dn.items():
        cfg.MODEL.DEPTH_NET[k] = v
    cfg.TPU.COMPUTE_DTYPE = compute_dtype(device)
    loss = cfg.LOSS
    loss.VARIANCE_FOCUS = 0.85
    if pose == "motion":
        cfg.MODEL.POSE_NET.NAME = "GoogleMotionNet"
        cfg.MODEL.POSE_NET.USE_DEPTH = True
        cfg.MODEL.POSE_NET.MASK_MOTION = True
        cfg.MODEL.POSE_NET.LEARN_SCALE = True
        cfg.MODEL.POSE_NET.SCALE_CONSTRAIN = "clip_ste"
        cfg.MODEL.POSE_NET.BURN_IN_ITERS = 20
        loss.NUM_SCALES = 1
        loss.SSIM_WEIGHT = 3.0
        loss.C1 = float("inf")
        loss.C2 = 9e-6
        loss.CLIP = 0.0
        loss.MOTION_SMOOTHNESS_WEIGHT = 1.0
        loss.MOTION_SPARSITY_WEIGHT = 0.2
        loss.ROT_CYCLE_WEIGHT = 1e-3
        loss.TRANS_CYCLE_WEIGHT = 5e-2
        loss.SMOOTHNESS_WEIGHT = 0.001
    elif pose:
        cfg.MODEL.POSE_NET.NAME = "PoseNet"
        cfg.MODEL.POSE_NET.NUM_CONTEXTS = 2
        loss.SSIM_WEIGHT = 0.85
        loss.C1, loss.C2, loss.CLIP = 1e-4, 9e-4, 0.0
        loss.AUTOMASK = True
        loss.SMOOTHNESS_WEIGHT = 0.001
        loss.PHOTOMETRIC_REDUCE = "min"

    rng = np.random.RandomState(0)
    K = np.tile(np.array([[[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    batch = {"img": rng.rand(B, H, W, 3).astype(np.float32), "intrinsics": K}
    if meta == "SupDepthModel":
        batch["depth"] = (rng.rand(B, H, W, 1) * 60).astype(np.float32)
    else:
        n_ctx = 2 if pose is True else 1
        batch["img_orig"] = batch["img"].copy()
        batch["ctx_img"] = rng.rand(B, n_ctx, H, W, 3).astype(np.float32)
        batch["ctx_img_orig"] = batch["ctx_img"].copy()
        batch["flip"] = np.zeros((B,), bool)
    if pose == "motion":
        # the step takes the noise and the motion weight from the batch (no schedule_fn)
        batch["noise_stddev"] = np.float32(0.1)
        batch["motion_weight"] = np.float32(1.0)
    return cfg, _on_device(batch, device)


def flagship_cfg(dtype: str = "float32"):
    """The flagship MonoDepth2-R18 config of the report tools (random-init
    encoder, PoseNet with two contexts, ``adam_multistep``)."""
    from simpledepthestimation_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.META_ARCHITECTURE = "MonoDepth2Model"
    cfg.MODEL.DEPTH_NET.NAME = "DepthResNet"
    cfg.MODEL.DEPTH_NET.ENCODER_NAME = "18"
    cfg.MODEL.DEPTH_NET.UPSAMPLE_DEPTH = False
    cfg.MODEL.POSE_NET.NAME = "PoseNet"
    cfg.MODEL.POSE_NET.NUM_CONTEXTS = 2
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.LOSS.SSIM_WEIGHT = 0.85
    cfg.LOSS.C1 = 1e-4
    cfg.LOSS.C2 = 9e-4
    cfg.LOSS.CLIP = 0.0
    cfg.LOSS.AUTOMASK = True
    cfg.LOSS.SMOOTHNESS_WEIGHT = 0.001
    cfg.LOSS.PHOTOMETRIC_REDUCE = "min"
    cfg.LOSS.SUPERVISED_WEIGHT = 0.0
    cfg.LOSS.VAR_LOSS_WEIGHT = 0.0
    cfg.SOLVER.OPT = "adam_multistep"
    cfg.SOLVER.DEPTH_LR = 2e-4
    cfg.SOLVER.POSE_LR = 2e-4
    cfg.SOLVER.LR_STEPS = (15,)
    return cfg


def flagship_batch(batch_size: int, H: int, W: int, n_ctx: int = 2, device="cuda"):
    """The flagship's seeded train batch on ``device`` (NCHW), ``img_orig`` and
    ``ctx_img_orig`` the same tensors as ``img`` and ``ctx_img``."""
    rng = np.random.RandomState(0)
    img = rng.rand(batch_size, H, W, 3).astype(np.float32)
    ctx = rng.rand(batch_size, n_ctx, H, W, 3).astype(np.float32)
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 0.58 * W, H / 2], [0, 0, 1]]], np.float32),
                (batch_size, 1, 1))
    out = _on_device({"img": img, "ctx_img": ctx, "intrinsics": K, "flip": np.zeros((batch_size,), bool)}, device)
    out["img_orig"], out["ctx_img_orig"] = out["img"], out["ctx_img"]
    return out


def warm_start_line(name: str, cfg, state) -> str:
    """What the ImageNet warm start of ``create_train_state`` did for this case."""
    from simpledepthestimation_tpu_torch.models.pretrained import BTS_CONVERTIBLE

    version = str(cfg.MODEL.DEPTH_NET.get("ENCODER_NAME", ""))
    if state.pretrained_weights:
        return f"{name}: warm start from {state.pretrained_weights}"
    if (version.endswith("pt") and version[:2].isdigit()) or version in BTS_CONVERTIBLE:
        return f"{name}: encoder {version!r} asks for ImageNet weights; no local file: seeded weights"
    return f"{name}: no warm start (encoder {version!r}): seeded weights"


def build_step(cfg, device):
    """(state, step) of ``cfg`` on ``device``: seeded weights, 100 steps an
    epoch for the schedule, ``TPU.REMAT`` as the config says."""
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    state = create_train_state(cfg, device=device, generator=torch.Generator().manual_seed(0),
                               steps_per_epoch=100)
    return state, make_train_step(state, remat=bool(cfg.TPU.REMAT))


def bench_case(name, meta, dn, pose, B, H, W, opts=(), device="cuda",
               warm_steps=WARM_STEPS, chunks=CHUNKS, chunk_steps=CHUNK_STEPS):
    """Time one family: ``warm_steps`` steps, then ``chunks`` chunks of
    ``chunk_steps`` steps, each chunk ended by ``float()`` of its loss (the
    wait for the card). Prints the warm-start line and the result line;
    returns ``{"name", "B", "H", "W", "images_per_s", "last_loss", "steps"}``."""
    from simpledepthestimation_tpu_torch.models.build import resolve_device

    device = resolve_device(device)
    cfg, batch = make_case(meta, dn, pose, B, H, W, opts, device=device)
    state, step = build_step(cfg, device)
    print(warm_start_line(name, cfg, state), flush=True)

    for _ in range(warm_steps):
        m = step(batch)
    float(m["total_loss"])
    n = 0
    t0 = time.perf_counter()
    for _ in range(chunks):
        for _ in range(chunk_steps):
            m = step(batch)
            n += 1
        loss = float(m["total_loss"])
    dt = time.perf_counter() - t0
    rate = B * n / dt
    print(f"{name:<20} B={B:<3} {H}x{W}:  {rate:7.1f} img/s/card", flush=True)
    return {"name": name, "B": B, "H": H, "W": W, "images_per_s": rate, "last_loss": loss,
            "steps": warm_steps + n}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", default="", help="run only this family (prefix match)")
    p.add_argument("--sweep", default="", help="comma-separated batch sizes to sweep (per family)")
    p.add_argument("--device", default="cuda", help="torch device to run on (default: the CUDA card)")
    p.add_argument("opts", nargs="*", default=[], help="trailing KEY VALUE cfg overrides")
    return p.parse_args(argv)


def main(argv=None):
    """Bench every family that ``--family`` selects; returns their results."""
    args = parse_args(argv)
    results = []
    for name, meta, dn, pose, B, H, W, case_opts in CASES:
        if args.family and not name.lower().startswith(args.family.lower()):
            continue
        for b in ([int(x) for x in args.sweep.split(",")] if args.sweep else [B]):
            results.append(bench_case(name, meta, dn, pose, b, H, W, tuple(case_opts) + tuple(args.opts),
                                      device=args.device))
    return results


if __name__ == "__main__":
    main()
