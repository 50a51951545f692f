"""Helpers shared by the tests of the PyTorch port (``tests/test_torch_*.py``).

The JAX package is NHWC, the port is NCHW: the transposes live here, never in
either package. Inputs are made with numpy from a seed and handed to both
sides as numpy arrays.
"""

import os

import numpy as np
import torch

# The suite runs in several pytest-xdist workers on one machine (6 in ROADMAP.md's
# tier-1 command). torch's default of one OpenMP thread per core in each of them
# oversubscribes the CPU, and the spinning threads cost more than they add: at two
# threads per worker the port's tests take half the wall time and 40 % of the CPU
# time they take at the default (8 cores, 6 workers).
torch.set_num_threads(2)

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


# --- coordinate regimes of the bilinear warp (x, y builders, [B,H,W] each) ---

def _grid(B, H, W):
    xs = np.tile(np.arange(W, dtype=np.float32), (B, H, 1))
    ys = np.tile(np.arange(H, dtype=np.float32)[:, None], (B, 1, W))
    return xs, ys


def _coherent(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return xs - 5.0 * rng.rand(B, H, W) + 2.0 * (rng.rand(B, H, W) - 0.5), ys + 3.0 * (rng.rand(B, H, W) - 0.5)


def _wild(rng, B, H, W):
    return rng.rand(B, H, W) * (W - 1), rng.rand(B, H, W) * (H - 1)


def _bidirectional(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return (np.clip(xs + 170 * (rng.rand(B, H, W) - 0.5), 0, W - 1),
            np.clip(ys + 150 * (rng.rand(B, H, W) - 0.5), 0, H - 1))


def _oob_borders(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return xs - 20 * rng.rand(B, H, W) + 10, ys + 10 * (rng.rand(B, H, W) - 0.7)


def _fully_outside(rng, B, H, W):
    return (rng.rand(B, H, W) * 3 - 1) * W, (rng.rand(B, H, W) * 3 - 1) * H


def _minus_one_to_zero(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return -rng.rand(B, H, W), ys - rng.rand(B, H, W)


def _exact_edges(rng, B, H, W):
    """Integer coordinates incl. x == W-1 and y == H-1 (corner at W / H is masked)."""
    xs, ys = _grid(B, H, W)
    x = np.where(rng.rand(B, H, W) < 0.5, W - 1.0, xs)
    y = np.where(rng.rand(B, H, W) < 0.5, H - 1.0, ys)
    return x, y


def _bimodal_border_clip(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    y = np.where(rng.rand(B, H, W) < 0.5, 0.0, H - 1.0)
    return xs + rng.rand(B, H, W), y


def _large_uniform_shift(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return xs + 0.4 * W + rng.rand(B, H, W), ys - 0.3 * H + rng.rand(B, H, W)


REGIMES = {
    "coherent": _coherent,
    "wild": _wild,
    "bidirectional-large": _bidirectional,
    "oob-borders": _oob_borders,
    "fully-outside": _fully_outside,
    "x-in-minus1-0": _minus_one_to_zero,
    "exact-edges": _exact_edges,
    "bimodal-border-clip": _bimodal_border_clip,
    "large-uniform-shift": _large_uniform_shift,
}


# --- the Supervised family (SupDepthModel with DepthResNet or BtsModel) ---

SUPERVISED = os.path.join(REPO, "projects", "Supervised", "configs")


def supervised_cfgs(yaml_name, overrides=()):
    """``projects/Supervised/configs/<yaml_name>`` with ``overrides`` under both
    packages: returns (jax_cfg, torch_cfg)."""
    from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
    from simpledepthestimation_tpu_torch.config import get_cfg as get_cfg_torch

    out = []
    for get_cfg in (get_cfg_jax, get_cfg_torch):
        cfg = get_cfg()
        cfg.merge_from_file(os.path.join(SUPERVISED, yaml_name))
        cfg.merge_from_list(list(overrides))
        out.append(cfg)
    return tuple(out)


def reference_state_dict(port_sd, cfg):
    """The port's ``state_dict`` under the names the JAX package's
    ``convert_meta_arch`` reads: a BTS encoder trunk is the original code's
    ``encoder.base_model`` (torchvision's ``features`` itself for DenseNet and
    MobileNetV2); every other name is already the reference's."""
    if str(cfg.MODEL.DEPTH_NET.NAME) != "BtsModel":
        return dict(port_sd)
    out = {}
    for k, v in port_sd.items():
        if k.startswith("depth_net.encoder.encoder."):
            rest = k[len("depth_net.encoder.encoder."):]
            k = "depth_net.encoder.base_model." + (rest[len("features."):] if rest.startswith("features.") else rest)
        out[k] = v
    return out


def shared_variables(port_model, cfg_jax, seed=1):
    """Perturbed Flax variables (numpy) made from the port model's seeded init
    through the JAX package's ``convert_meta_arch`` (no JAX ``init`` compile),
    loaded back into ``port_model``: both sides then hold the same float32 values."""
    from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
    from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables

    sd = {k: v for k, v in port_model.state_dict().items() if not k.endswith("num_batches_tracked")}
    params, stats = convert_meta_arch(reference_state_dict(sd, cfg_jax), cfg_jax)
    variables = randomize_variables(to_numpy_tree({"params": params, "batch_stats": stats}), seed=seed)
    load_flax_variables(port_model, variables["params"], variables["batch_stats"])
    return variables


def make_sup_batch(seed=0, B=2, H=64, W=96, flip=None):
    """A Supervised batch as numpy NHWC arrays: smooth frames, ground-truth depth
    in (0, 40) with a third of the pixels at or below 1 (outside ``silog_loss``'s
    ``gt > 1`` mask), KITTI-like intrinsics, and ``flip``."""
    rng = np.random.RandomState(seed)
    img = smooth_field(rng, B, H, W, 3)
    depth = (1.5 + 38.0 * smooth_field(rng, B, H, W, 1)).astype(np.float32)
    depth[rng.rand(B, H, W, 1) < 1 / 3] = rng.rand() * 1.0
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    K[:, 0, 0] *= 1.0 + 0.1 * np.arange(B, dtype=np.float32)  # focals differ between the samples
    return {"img": img, "depth": depth, "intrinsics": K,
            "flip": np.zeros((B,), bool) if flip is None else np.asarray(flip, bool)}


WAYMO_HW = (1280, 1920)  # a Waymo FRONT frame
WAYMO_FOCAL, WAYMO_CENTER = 2055.5, (939.7, 641.1)  # f, (cx, cy) of a FRONT camera


def waymo_depth_image(rng, hw=WAYMO_HW, n_points=60000, focal=WAYMO_FOCAL, center=WAYMO_CENTER):
    """A sparse camera-Z depth map of a seeded lidar-like point cloud (vehicle
    frame: x forward, 4-80 m), made as the extraction tool makes it: the port's
    ``project_points_to_camera`` for a camera 1.5 m ahead of and 2.1 m above the
    vehicle's origin, pixels rounded, ``scatter_depth_image``. uint16 x255."""
    from simpledepthestimation_tpu_torch.data.datasets import waymo_extract as wx

    pts = np.stack([rng.uniform(4, 80, n_points), rng.uniform(-30, 30, n_points),
                    rng.uniform(-2.1, 3.0, n_points)], axis=-1)
    extrinsic = np.eye(4)
    extrinsic[:3, 3] = [1.5, 0.0, 2.1]
    u, v, depth = wx.project_points_to_camera(pts, extrinsic, wx.intrinsic_matrix4(focal, focal, *center))
    return wx.encode_depth_png(wx.scatter_depth_image(hw[0], hw[1], np.round(u), np.round(v), depth))


def make_waymo_tree(root, n_frames=8, n_val=40, hw=WAYMO_HW, seed=0):
    """An extracted Waymo tree as ``tools/extract_waymo_data.py`` lays it out:
    ``image/seg-a/{i:05d}/FRONT.jpg`` (smooth colour fields, 4:2:0 JPEG written
    with Pillow), ``depth/.../FRONT_depth.png`` (``waymo_depth_image``, written
    with ``cv2.imwrite``) and ``mask/.../FRONT_mask.png`` (8-bit, 0/255 blobs),
    for ``n_frames`` frames of one segment; and three infos pickles built with
    the port's ``build_frame_info``/``assemble_infos``: ``train.pkl`` (the
    frames), ``pair.pkl`` (the first two) and ``val.pkl`` (``n_val`` records of
    a second segment whose directories cycle through the frames, so that
    ``DOWNSAMPLE: 20`` keeps ``n_val // 20`` of them). Returns the paths."""
    import pickle

    import cv2
    from PIL import Image

    from simpledepthestimation_tpu_torch.data.datasets import waymo_extract as wx

    rng = np.random.default_rng(seed)
    H, W = hw
    K = np.array([[WAYMO_FOCAL, 0, WAYMO_CENTER[0]], [0, WAYMO_FOCAL, WAYMO_CENTER[1]], [0, 0, 1]], np.float32)
    calib = {"FRONT": {"intrinsics": K, "extrinsics": np.eye(4, dtype=np.float32)}}
    paths = {k: os.path.join(root, k) for k in ("image", "depth", "mask")}
    frames = []
    for i in range(n_frames):
        rel = os.path.join("seg-a", f"{i:05d}")
        for d in paths.values():
            os.makedirs(os.path.join(d, rel), exist_ok=True)
        low = rng.random((H // 32 + 2, W // 32 + 2, 3)).astype(np.float32)
        img = (cv2.resize(low, (W, H), interpolation=cv2.INTER_CUBIC).clip(0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(paths["image"], rel, "FRONT.jpg"), quality=90, subsampling=2)
        cv2.imwrite(os.path.join(paths["depth"], rel, "FRONT_depth.png"), waymo_depth_image(rng, hw))
        mask = (cv2.resize(rng.random((H // 64, W // 64)).astype(np.float32), (W, H)) > 0.7).astype(np.uint8) * 255
        cv2.imwrite(os.path.join(paths["mask"], rel, "FRONT_mask.png"), mask)
        frames.append(wx.build_frame_info("seg-a", i, rel, calib))
    val = [wx.build_frame_info("seg-v", j, frames[j % n_frames]["rel_dir"], calib) for j in range(n_val)]
    infos = {"train": wx.assemble_infos([frames[::-1]]), "pair": wx.assemble_infos([frames[:2]]),
             "val": wx.assemble_infos([val])}
    for name, payload in infos.items():
        paths[name] = os.path.join(root, f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(payload, f)
    return paths


def waymo_overrides(paths, family):
    """KEY VALUE pairs pointing ``Base_waymo.yaml``'s loaders of ``family`` at a
    ``make_waymo_tree`` tree: TRAIN reads ``train.pkl`` (Supervised:
    ``pair.pkl``), TEST ``val.pkl``."""
    train_split = paths["pair" if family == "Supervised" else "train"]
    opts = []
    for split, infos in (("TRAIN", train_split), ("TEST", paths["val"])):
        opts += [f"DATASETS.{split}.DATA_ROOT", paths["image"], f"DATASETS.{split}.DEPTH_ROOT", paths["depth"],
                 f"DATASETS.{split}.SPLIT", infos]
    if family == "MotionLearning":
        opts += ["DATASETS.TRAIN.MASK_ROOT", paths["mask"]]
    return opts
