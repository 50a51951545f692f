"""Helpers shared by the tests of the PyTorch port (``tests/test_torch_*.py``).

The JAX package is NHWC, the port is NCHW: the transposes live here, never in
either package. Inputs are made with numpy from a seed and handed to both
sides as numpy arrays.
"""

import os

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def nchw(a):
    """numpy NHWC (or [B,N,H,W,C]) → torch NCHW (or [B,N,C,H,W]), contiguous."""
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(0, 3, 1, 2)
    elif a.ndim == 5:
        a = a.transpose(0, 1, 4, 2, 3)
    else:
        raise ValueError(a.shape)
    return torch.from_numpy(np.ascontiguousarray(a))


def nhwc(t):
    """torch NCHW → numpy NHWC."""
    return t.detach().cpu().numpy().transpose(0, 2, 3, 1)


def to_numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def monodepth2_cfgs(overrides=()):
    """The MonoDepth2-R18 config (random-init encoder, float32) under both
    packages: returns (jax_cfg, torch_cfg)."""
    from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
    from simpledepthestimation_tpu_torch.config import get_cfg as get_cfg_torch

    path = os.path.join(REPO, "projects", "MonoDepth2", "configs", "resnet18.yaml")
    opts = ["MODEL.DEPTH_NET.ENCODER_NAME", "18", "TPU.COMPUTE_DTYPE", "float32", *overrides]
    out = []
    for get_cfg in (get_cfg_jax, get_cfg_torch):
        cfg = get_cfg()
        cfg.merge_from_file(path)
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return tuple(out)


def smooth_field(rng, B, H, W, C, cell=8):
    """Low-frequency random images in [0,1): a coarse random grid, one value
    per ``cell`` pixels, interpolated bilinearly. [B,H,W,C] float32."""
    low = rng.rand(B, H // cell + 2, W // cell + 2, C)
    ys, xs = np.arange(H) / cell, np.arange(W) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[None, :, None, None], (xs - x0)[None, None, :, None]
    rows0, rows1 = low[:, y0], low[:, y0 + 1]
    top = rows0[:, :, x0] * (1 - fx) + rows0[:, :, x0 + 1] * fx
    bot = rows1[:, :, x0] * (1 - fx) + rows1[:, :, x0 + 1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def make_batch(seed=0, B=2, H=64, W=256, N=2, with_depth=False, flip=None, smooth=False):
    """A MonoDepth2 training batch as numpy NHWC arrays (the JAX layout).

    ``smooth=False``: white-noise frames, on which the identity reprojection
    beats every warp, so the automask cuts the warp (and the pose net) off from
    the loss. ``smooth=True``: low-frequency frames whose contexts are the
    target shifted sideways by a few pixels plus a little noise, so that warped
    and identity maps each win the minimum somewhere: the batch for gradients."""
    rng = np.random.RandomState(seed)
    if smooth:
        img = smooth_field(rng, B, H, W, 3)
        shifts = [(-1) ** j * (2 + j // 2) for j in range(N)]
        ctx = np.stack([np.roll(img, s, axis=2) for s in shifts], axis=1)
        ctx = (ctx + 0.01 * rng.rand(B, N, H, W, 3)).astype(np.float32)
    else:
        img = rng.rand(B, H, W, 3).astype(np.float32)
        ctx = (0.7 * img[:, None] + 0.3 * rng.rand(B, N, H, W, 3)).astype(np.float32)
    K = np.tile(
        np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1)
    )
    batch = {
        "img": img,
        "img_orig": img,
        "ctx_img": ctx,
        "ctx_img_orig": ctx,
        "intrinsics": K,
        "flip": np.zeros((B,), bool) if flip is None else np.asarray(flip, bool),
    }
    if with_depth:
        batch["depth"] = (rng.rand(B, H, W, 1) * 30.0).astype(np.float32)
    return batch


def batch_to_torch(batch):
    """NHWC numpy batch → the port's NCHW torch batch (CPU)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = nchw(v) if v.ndim >= 4 else torch.from_numpy(v.copy())
    return out


def randomize_variables(variables, seed=1):
    """Perturb an initialised Flax variables tree (numpy leaves) so that norm
    scales, biases and running statistics are not the 1/0 of a fresh init."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        if hasattr(tree, "items"):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree)
        leaf = path[-1]
        if leaf in ("scale", "var"):
            return (0.5 + rng.rand(*a.shape)).astype(a.dtype)
        if leaf in ("bias", "mean"):
            return (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        return np.array(a)

    return walk(variables)


def init_jax_monodepth2(cfg_jax, batch, seed=0):
    """(model, variables as numpy trees) of the JAX MonoDepth2 model."""
    import jax
    import jax.numpy as jnp

    from simpledepthestimation_tpu.models import build_model

    model = build_model(cfg_jax)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(seed), jb, train=True))()
    return model, randomize_variables(to_numpy_tree(variables))
