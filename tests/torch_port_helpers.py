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


def make_batch(seed=0, B=2, H=64, W=256, N=2, with_depth=False, flip=None):
    """A MonoDepth2 training batch as numpy NHWC arrays (the JAX layout)."""
    rng = np.random.RandomState(seed)
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
