"""The port's data pipeline (``simpledepthestimation_tpu_torch/data``) against
the JAX package's, which runs on OpenCV; the port imports no OpenCV.

- Loaders: the same config gives the same batches, key by key, NHWC → NCHW,
  on the synthetic dataset (``synthetic_quick.yaml`` of both families:
  RandomFlip, RandomImageAug, ToTensor; 64x96, B=4, two epochs) and on a
  fabricated KITTI tree (``resnet18.yaml``'s lists: LoadImg, Resize, LoadDepth
  with KEEP_ORIG, ClipDepth). Limit: equal. The jittered frames are compared
  as float32, so equal means byte-equal after ×255 and more.
- The OpenCV arithmetic the port reproduces, on random shapes: ``cv2.resize``
  INTER_LINEAR on uint8 and INTER_NEAREST (equal), and the jitter ops (uint8
  results equal; float32 results bit-equal where a row is a multiple of 16
  pixels wide: at the last pixels of other rows OpenCV's scalar tail code
  rounds in the last bit otherwise, ``data/preprocess/augmentation.py``).
- PNG: the reader against ``cv2.imread`` and the writer (16-bit and 8-bit gray) read back by it, equal.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.data import build_test_loader as jax_test_loader
from simpledepthestimation_tpu.data import build_train_loader as jax_train_loader
from simpledepthestimation_tpu.data.preprocess import augmentation as jax_aug
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.data import build_test_loader, build_train_loader
from simpledepthestimation_tpu_torch.data.png import read_png, write_png
from simpledepthestimation_tpu_torch.data.preprocess import augmentation as aug

from test_kitti_e2e import _make_kitti
from torch_port_helpers import REPO


def _cfgs(yaml, opts):
    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(os.path.join(REPO, "projects", *yaml))
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return out


def _as_nhwc(v):
    a = v.numpy()
    if a.ndim == 4:
        return a.transpose(0, 2, 3, 1)
    if a.ndim == 5:
        return a.transpose(0, 1, 3, 4, 2)
    return a


def _assert_same_batches(jax_loader, port_loader, epochs):
    n = 0
    for epoch in range(epochs):
        jax_loader.set_epoch(epoch)
        port_loader.set_epoch(epoch)
        batches = list(zip(jax_loader, port_loader))
        assert len(batches) == len(port_loader) > 0
        for jb, tb in batches:
            assert set(jb) == set(tb)
            for k, jv in jb.items():
                tv = tb[k]
                if isinstance(jv, np.ndarray):
                    assert isinstance(tv, torch.Tensor) and tv.dtype == (torch.bool if k == "flip" else torch.float32)
                    if tv.dim() >= 4:
                        assert tv.shape[-3] in (1, 3) and tv.is_contiguous(), (k, tuple(tv.shape))
                    np.testing.assert_array_equal(_as_nhwc(tv), jv, err_msg=k)
                elif k == "metadata":
                    assert tv == jv
                else:
                    assert len(tv) == len(jv)
                    for a, b in zip(tv, jv):
                        np.testing.assert_array_equal(a, b, err_msg=k)
            n += 1
    return n


SYNTHETIC = {
    "MonoDepth2": ("MonoDepth2", "configs", "synthetic_quick.yaml"),
    "MotionLearning": ("MotionLearning", "configs", "synthetic_quick.yaml"),
}


@pytest.mark.parametrize("family", sorted(SYNTHETIC))
def test_synthetic_loaders_match_jax(family):
    opts = ["DATASETS.TRAIN.IMG_HEIGHT", 64, "DATASETS.TRAIN.IMG_WIDTH", 96, "DATASETS.TRAIN.LENGTH", 8,
            "DATASETS.TEST.IMG_HEIGHT", 64, "DATASETS.TEST.IMG_WIDTH", 96, "SOLVER.IMS_PER_BATCH", 4,
            "DATALOADER.NUM_WORKERS", 2]
    cfg_j, cfg_t = _cfgs(SYNTHETIC[family], opts)
    jl, tl = jax_train_loader(cfg_j, seed=1), build_train_loader(cfg_t, seed=1)
    assert _assert_same_batches(jl, tl, epochs=2) == 4
    first = next(iter(tl))
    assert not torch.equal(first["img"], first["img_orig"])  # the jitter ran
    if family == "MonoDepth2":
        assert first["ctx_img"].shape == (4, 2, 3, 64, 96) and first["depth"].shape == (4, 1, 64, 96)
    assert _assert_same_batches(jax_test_loader(cfg_j), build_test_loader(cfg_t), epochs=1) == 4


def test_kitti_loaders_match_jax(tmp_path):
    root = str(tmp_path / "kitti")
    split = _make_kitti(root, n=10)
    opts = []
    for s in ("TRAIN", "TEST"):
        opts += [f"DATASETS.{s}.DATA_ROOT", os.path.join(root, "raw"), f"DATASETS.{s}.SPLIT", split]
    opts += ["DATASETS.TEST.DEPTH_ROOT", os.path.join(root, "refined"), "SOLVER.IMS_PER_BATCH", 4,
             "TEST.IMS_PER_BATCH", 2, "DATALOADER.NUM_WORKERS", 2]
    cfg_j, cfg_t = _cfgs(("MonoDepth2", "configs", "resnet18.yaml"), opts)
    n = _assert_same_batches(jax_train_loader(cfg_j, seed=3), build_train_loader(cfg_t, seed=3), epochs=1)
    assert n == 2  # 8 frames have both contexts
    batch = next(iter(build_train_loader(cfg_t, seed=3)))
    assert batch["img"].shape == (4, 3, 192, 640) and batch["ctx_img_orig"].shape == (4, 2, 3, 192, 640)
    assert _assert_same_batches(jax_test_loader(cfg_j), build_test_loader(cfg_t), epochs=1) == 5
    test_batch = next(iter(build_test_loader(cfg_t)))
    assert test_batch["depth"].shape == (2, 1, 192, 640) and test_batch["depth_orig"][0].shape == (96, 128)


def test_resize_matches_cv2():
    rng = np.random.default_rng(0)
    shapes = [(96, 128, 192, 640), (375, 1242, 192, 640), (375, 1242, 128, 416), (100, 100, 50, 50)]
    shapes += [tuple(int(v) for v in rng.integers(2, 160, 4)) for _ in range(40)]
    for H, W, dh, dw in shapes:
        for C in (1, 3):
            img = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
            want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR).reshape(dh, dw, C)
            np.testing.assert_array_equal(aug.resize_linear_u8(img, dw, dh), want, err_msg=str((H, W, dh, dw, C)))
        depth = rng.random((H, W), dtype=np.float32)
        want = cv2.resize(depth, (dw, dh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(aug.resize_nearest(depth, dw, dh), want, err_msg=str((H, W, dh, dw)))


def test_photometric_jitter_matches_the_jax_package():
    rng = np.random.default_rng(1)
    ops = [(aug.adjust_brightness, jax_aug.adjust_brightness, (0.8, 1.2)),
           (aug.adjust_contrast, jax_aug.adjust_contrast, (0.8, 1.2)),
           (aug.adjust_saturation, jax_aug.adjust_saturation, (0.8, 1.2)),
           (aug.adjust_hue, jax_aug.adjust_hue, (-0.05, 0.05))]
    for trial in range(60):
        H = int(rng.integers(1, 50))
        W = 16 * int(rng.integers(1, 8)) if trial % 2 == 0 else int(rng.integers(1, 100))
        img = jax_aug._to_float(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        a, b = img.copy(), img.copy()
        for i in rng.permutation(4):
            port_op, jax_op, bounds = ops[i]
            f = float(rng.uniform(*bounds))
            a, b = port_op(a, f), jax_op(b, f).reshape(a.shape)
        if W % 16 == 0:
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(aug._to_uint8(a), jax_aug._to_uint8(b).reshape(a.shape))
    # the HSV edge cases: gray pixels, ties of the largest channel, black and white
    img = np.array([[[0.5, 0.5, 0.5], [0.2, 0.7, 0.7], [0.7, 0.7, 0.2], [0.7, 0.2, 0.7],
                     [0, 0, 0], [1, 1, 1], [0.3, 0.3, 0.9], [0.9, 0.1, 0.4]]] * 2, np.float32)
    np.testing.assert_array_equal(aug._rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_array_equal(aug._hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _smooth(rng, shape):
    """Slowly varying pixels: OpenCV's PNG encoder then picks every scanline filter."""
    return np.clip(np.cumsum(rng.integers(-3, 4, shape), axis=1) + 128, 0, 255)


def test_png_reader_matches_cv2_imread(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "x.png")
    cases = {
        "rgb8": rng.integers(0, 256, (37, 61, 3)).astype(np.uint8),
        "rgb8_smooth": _smooth(rng, (40, 70, 3)).astype(np.uint8),
        "gray8": _smooth(rng, (33, 50)).astype(np.uint8),
        "gray16": (rng.uniform(2, 60, (29, 47)) * 255).astype(np.uint16),
        "gray16_smooth": (_smooth(rng, (30, 44)) * 257).astype(np.uint16),
        "rgba8": _smooth(rng, (21, 34, 4)).astype(np.uint8),
    }
    for name, img in cases.items():
        stored = img[..., [2, 1, 0, 3][: img.shape[2]]] if img.ndim == 3 else img  # imwrite takes BGR(A)
        assert cv2.imwrite(path, stored)
        got = read_png(path)
        assert got.dtype == img.dtype, name
        np.testing.assert_array_equal(got, img, err_msg=name)
        np.testing.assert_array_equal(got[..., [2, 1, 0, 3][: img.shape[2]]] if img.ndim == 3 else got,
                                      cv2.imread(path, cv2.IMREAD_UNCHANGED), err_msg=name)


def test_png_writer_reads_back_through_cv2(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "y.png")
    depth = (rng.uniform(0, 80, (23, 41)) * 255).astype(np.uint16)
    depth[0, :3] = (0, 1, 65535)
    for img in (depth, depth.T, np.zeros((1, 1), np.uint16)):  # depth.T: not contiguous
        write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(read_png(path), img)
    mask = (rng.random((23, 41)) > 0.5).astype(np.uint8) * 255  # an 8-bit gray mask
    write_png(path, mask)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), mask)
    np.testing.assert_array_equal(read_png(path), mask)
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 3), np.uint16)):
        with pytest.raises(ValueError):
            write_png(path, bad)
