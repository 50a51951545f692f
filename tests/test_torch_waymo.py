"""Waymo in the port (``data/datasets/{waymo,waymo_extract}.py``, JPEG frames)
against the JAX package, on fabricated trees (no Waymo data is in the
repository).

- (a) The extraction math: each function of the port's ``waymo_extract`` on
  the same seeded points, extrinsics and intrinsics as the JAX package's.
  Limit: equal to the bit (the same numpy). And what
  ``tests/test_waymo_extract.py`` holds of the JAX copy: the projection's
  round trip (1e-9 relative, 1e-8 m), camera Z and not range, the scatter,
  the uint16 x255 round trip (1/255 m) and the infos order.
- (b) ``WaymoDepth``: ``len``, the sample list, every sample's metadata and
  intrinsics equal to the JAX ``WaymoDepth``'s on the same infos: windows,
  ``DOWNSAMPLE`` (before the frames are grouped, so contexts are
  ``DOWNSAMPLE`` frames apart), two cameras with their own focals, two
  segments (no window crosses one), a forward-only context with masks, a
  bare list of frames, ``STRIDE`` 2.
- (c) The TRAIN and TEST loaders of the three ``Base_waymo.yaml`` on one tree
  of 1280x1920 JPEG frames, sparse uint16 depth and 8-bit masks: every key
  equal, frames equal to the bit (every width here is a multiple of 16, so the
  jitter's float32 is bit-equal too; ``tests/test_torch_data.py``), and the
  intrinsics as ``CropTopTo`` and ``Resize`` must leave the calibration's.
- (d) ``CropTopTo`` (768 rows of 1280) and ``RandomCrop`` (352x704 of
  768x1920) forward and backward against the JAX package's, equal.
- (e) The four KITTI evaluators on the TEST pipelines' samples with the same
  seeded predictions, through both packages' inverse preprocess chain
  (``Resize`` back to 768x1920, ``CropTopTo`` back to 1280x1920), the Garg
  crop and ``GT_SCALE`` (MonoDepth2 on, Supervised off). Limit: 1e-7 relative
  (measured: 0 on every row; both packages run the same numpy).
"""

import os
import pickle

import numpy as np
import pytest

from simpledepthestimation_tpu.config import CfgNode as JaxCfgNode
from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.data import DATASET_REGISTRY as JAX_DATASETS
from simpledepthestimation_tpu.data import build_preprocess as jax_build_preprocess
from simpledepthestimation_tpu.data import build_test_loader as jax_test_loader
from simpledepthestimation_tpu.data import build_train_loader as jax_train_loader
from simpledepthestimation_tpu.data.datasets import waymo_extract as jax_wx
from simpledepthestimation_tpu.evaluation import build_evaluator as jax_build_evaluator
from simpledepthestimation_tpu_torch.config import CfgNode, get_cfg
from simpledepthestimation_tpu_torch.data import DATASET_REGISTRY, build_preprocess, build_test_loader, build_train_loader
from simpledepthestimation_tpu_torch.data.datasets import waymo_extract as wx
from simpledepthestimation_tpu_torch.evaluation import build_evaluator

from test_torch_data import _assert_same_batches, _cfgs
from torch_port_helpers import WAYMO_CENTER, WAYMO_FOCAL, make_waymo_tree, waymo_overrides

EVAL_RTOL = 1e-7
FAMILIES = ("MonoDepth2", "MotionLearning", "Supervised")


# ---------------------------------------------------------------------------
# (a) the extraction math
# ---------------------------------------------------------------------------


def _camera(rng):
    theta = rng.uniform(-0.1, 0.1)
    extrinsic = np.eye(4)
    extrinsic[:2, :2] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    extrinsic[:3, 3] = rng.uniform([1.0, -0.1, 1.8], [1.8, 0.1, 2.4])
    return extrinsic, wx.intrinsic_matrix4(*rng.uniform([2000, 2000, 900, 600], [2100, 2100, 980, 680]))


def _points(rng, n=500):
    return np.stack([rng.uniform(5, 60, n), rng.uniform(-10, 10, n), rng.uniform(-2, 4, n)], axis=-1)


def test_extraction_math_is_bit_equal_to_the_jax_package():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(wx.AXIS_SWAP, jax_wx.AXIS_SWAP)
    assert wx.AXIS_SWAP.dtype == jax_wx.AXIS_SWAP.dtype
    for _ in range(3):
        f_u, f_v, c_u, c_v = rng.uniform(100, 3000, 4)
        np.testing.assert_array_equal(wx.intrinsic_matrix4(f_u, f_v, c_u, c_v),
                                      jax_wx.intrinsic_matrix4(f_u, f_v, c_u, c_v))
        extrinsic, intrinsic4 = _camera(rng)
        pts = _points(rng)
        u, v, depth = wx.project_points_to_camera(pts, extrinsic, intrinsic4)
        for a, b in zip((u, v, depth), jax_wx.project_points_to_camera(pts, extrinsic, intrinsic4)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(wx.unproject_from_camera(u, v, depth, extrinsic, intrinsic4),
                                      jax_wx.unproject_from_camera(u, v, depth, extrinsic, intrinsic4))
        xs, ys = rng.integers(-20, 120, 400), rng.integers(-20, 90, 400)
        d = rng.uniform(-5, 80, 400)
        img = wx.scatter_depth_image(80, 100, xs, ys, d)
        np.testing.assert_array_equal(img, jax_wx.scatter_depth_image(80, 100, xs, ys, d))
        png = wx.encode_depth_png(img)
        assert png.dtype == np.uint16
        np.testing.assert_array_equal(png, jax_wx.encode_depth_png(img))
        np.testing.assert_array_equal(wx.decode_depth_png(png), jax_wx.decode_depth_png(png))
    calib = {"FRONT": {"intrinsics": np.eye(3, dtype=np.float32)}}
    per_segment = [[wx.build_frame_info(s, i, f"{s}/{i:05d}", calib) for i in rng.permutation(4)]
                   for s in ("seg_c", "seg_a", "seg_b")]
    jax_segments = [[jax_wx.build_frame_info(s, i, f"{s}/{i:05d}", calib) for i in rng.permutation(4)]
                    for s in ("seg_c", "seg_a", "seg_b")]
    assert wx.assemble_infos(per_segment) == jax_wx.assemble_infos(per_segment)
    assert wx.assemble_infos(per_segment) == wx.assemble_infos(jax_segments)


def test_projection_round_trip_and_camera_z():
    rng = np.random.default_rng(1)
    extrinsic, intrinsic4 = _camera(rng)
    pts = _points(rng)
    u, v, depth = wx.project_points_to_camera(pts, extrinsic, intrinsic4)
    assert np.all(depth > 0)
    np.testing.assert_allclose(wx.unproject_from_camera(u, v, depth, extrinsic, intrinsic4), pts, rtol=1e-9,
                               atol=1e-8)
    # one point straight ahead, one off-axis at the same forward distance: the same depth, not the range
    _, _, z = wx.project_points_to_camera(np.array([[10.0, 0.0, 0.0], [10.0, 5.0, 0.0]]), np.eye(4),
                                          wx.intrinsic_matrix4(100.0, 100.0, 50.0, 50.0))
    np.testing.assert_allclose(z, [10.0, 10.0], rtol=1e-12)


def test_scatter_png_round_trip_and_infos_order():
    img = wx.scatter_depth_image(5, 10, np.array([0, 5, 9, 10, -1, 3, 1]), np.array([0, 2, 4, 1, 1, -2, 1]),
                                 np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, -3.0]))
    assert img.shape == (5, 10) and img[0, 0] == 1.0 and img[2, 5] == 2.0 and img[4, 9] == 3.0
    assert img.sum() == pytest.approx(6.0)  # out of bounds and non-positive depth dropped
    depth = np.random.default_rng(2).uniform(0, 80, (16, 24)).astype(np.float32)
    np.testing.assert_allclose(wx.decode_depth_png(wx.encode_depth_png(depth)), depth, atol=1.0 / 255.0 + 1e-6)
    infos = wx.assemble_infos([[wx.build_frame_info("seg_b", 1, "seg_b/00001", {}),
                                wx.build_frame_info("seg_b", 0, "seg_b/00000", {})],
                               [wx.build_frame_info("seg_a", 0, "seg_a/00000", {})]])
    assert [(fr["segment"], fr["frame"]) for fr in infos["frames"]] == [("seg_a", 0), ("seg_b", 0), ("seg_b", 1)]


# ---------------------------------------------------------------------------
# (b) WaymoDepth against the JAX package's
# ---------------------------------------------------------------------------


def _infos(tmp_path, segments, cams=("FRONT",), as_list=False):
    frames = []
    for seg, n in segments.items():
        for i in range(n):
            calib = {cam: {"intrinsics": np.array([[2000.0 + 100 * c, 0, 960], [0, 2000.0 + 100 * c, 640], [0, 0, 1]],
                                                  np.float32 if c == 0 else np.float64)}
                     for c, cam in enumerate(cams)}
            frames.append(wx.build_frame_info(seg, i, os.path.join(seg, f"{i:05d}"), calib))
    payload = wx.assemble_infos([frames])
    path = str(tmp_path / "infos.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload["frames"] if as_list else payload, f)
    return path


DATASET_CASES = {
    # tests/test_waymo_kitti_datasets.py: windows, DOWNSAMPLE, two cameras with their own focals
    "windows": (dict(segments={"seg-000": 5}), dict(FORWARD_CONTEXT=1, BACKWARD_CONTEXT=1, WITH_DEPTH=True), 3),
    "downsample": (dict(segments={"seg-000": 8}), dict(DOWNSAMPLE=2), 4),
    "downsample_with_contexts": (dict(segments={"seg-000": 9}),
                                 dict(DOWNSAMPLE=2, FORWARD_CONTEXT=1, BACKWARD_CONTEXT=1), 3),
    "two_cameras": (dict(segments={"seg-000": 4}, cams=("FRONT", "FRONT_LEFT")),
                    dict(USE_CAMS=["FRONT", "FRONT_LEFT"], FORWARD_CONTEXT=1, BACKWARD_CONTEXT=1), 4),
    "two_segments": (dict(segments={"seg-b": 5, "seg-a": 4}), dict(FORWARD_CONTEXT=1, BACKWARD_CONTEXT=1), 5),
    "two_segments_stride_2": (dict(segments={"seg-b": 7, "seg-a": 5}),
                              dict(FORWARD_CONTEXT=1, BACKWARD_CONTEXT=1, STRIDE=2), 4),
    # MotionLearning: a forward context only, masks; no depth for the frame, but the contexts' depth paths
    "forward_only_with_masks": (dict(segments={"seg-a": 4, "seg-b": 3}),
                                dict(FORWARD_CONTEXT=1, MASK_ROOT="/m", WITH_DEPTH=False), 5),
    "bare_list": (dict(segments={"seg-a": 3}, as_list=True), dict(DOWNSAMPLE=1), 3),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_waymo_dataset_matches_jax(tmp_path, case):
    tree, keys, n = DATASET_CASES[case]
    fields = {"NAME": "WaymoDepth", "DATA_ROOT": "/img", "DEPTH_ROOT": "/depth", "SPLIT": _infos(tmp_path, **tree),
              "PREPROCESS": [], **keys}
    ds = DATASET_REGISTRY.get("WaymoDepth")(CfgNode(fields), get_cfg())
    ref = JAX_DATASETS.get("WaymoDepth")(JaxCfgNode(fields), get_cfg_jax())
    assert len(ds) == len(ref) == n
    assert ds.samples == ref.samples
    segment_of = {i: fr["segment"] for i, fr in enumerate(ds._frames)}
    for idx in range(len(ds)):
        got, want = ds[idx], ref.get_sample(idx, np.random.default_rng(0))
        assert set(got) == set(want) == {"metadata", "intrinsics"}
        assert got["metadata"] == want["metadata"]
        assert got["intrinsics"].dtype == np.float32
        np.testing.assert_array_equal(got["intrinsics"], want["intrinsics"])
        sample = ds.samples[idx]
        assert {segment_of[j] for j in sample["ctx_frames"]} <= {segment_of[sample["frame"]]}
        md = got["metadata"]
        assert md["img_dir"].endswith(f"{md['cam']}.jpg") and md["img_id"] == str(sample["frame"])
        assert md["depth_dir"] == (os.path.join("/depth", ds._frames[sample["frame"]]["rel_dir"], "FRONT_depth.png")
                                   if keys.get("WITH_DEPTH") else "")
    if case == "forward_only_with_masks":
        assert all(s["ctx_frames"] == [s["frame"] + 1] for s in ds.samples)
        md = ds[0]["metadata"]
        assert md["mask_dir"].endswith("FRONT_mask.png") and md["ctx_depth_dir"][0].endswith("FRONT_depth.png")
    if case == "downsample_with_contexts":  # frames 0, 2, ..., 8 kept; contexts two frames apart
        assert [[ds._frames[j]["frame"] for j in s["ctx_frames"]] for s in ds.samples] == [[0, 4], [2, 6], [4, 8]]
    if case == "two_cameras":
        assert {float(ds[i]["intrinsics"][0, 0]) for i in range(len(ds))} == {2000.0, 2100.0}
        assert [s["cam"] for s in ds.samples] == ["FRONT", "FRONT_LEFT"] * 2  # the camera innermost


# ---------------------------------------------------------------------------
# (c) the loaders of the three Base_waymo.yaml, (e) the evaluators on their TEST samples
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_waymo_tree(str(tmp_path_factory.mktemp("waymo")))


def _waymo_cfgs(tree, family, extra=()):
    opts = waymo_overrides(tree, family) + ["SOLVER.IMS_PER_BATCH", 2, "DATALOADER.NUM_WORKERS", 2, *extra]
    return _cfgs((family, "configs", "Base_waymo.yaml"), opts)


def _expected_intrinsics(h, w):
    """The calibration after ``CropTopTo`` (768 of 1280 rows: cy - 512) and a resize to h x w."""
    sx, sy = w / 1920, h / 768
    return np.array([[WAYMO_FOCAL * sx, 0, WAYMO_CENTER[0] * sx], [0, WAYMO_FOCAL * sy, (WAYMO_CENTER[1] - 512) * sy],
                     [0, 0, 1]], np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_waymo_loaders_match_jax(tree, family):
    cfg_j, cfg_t = _waymo_cfgs(tree, family)
    n = _assert_same_batches(jax_train_loader(cfg_j, seed=5), build_train_loader(cfg_t, seed=5), epochs=1)
    batch = next(iter(build_train_loader(cfg_t, seed=5)))
    if family == "MonoDepth2":  # 8 frames, DOWNSAMPLE 2: 2 frames have both contexts
        assert n == 1 and batch["ctx_img"].shape == (2, 2, 3, 192, 480)
        np.testing.assert_allclose(batch["intrinsics"][0].numpy(), _expected_intrinsics(192, 480), rtol=1e-6)
    elif family == "MotionLearning":  # 4 kept frames, a forward context: 3 samples, one batch of 2
        assert n == 1 and batch["ctx_img"].shape == (2, 1, 3, 128, 416)
        assert batch["mask"].shape == (2, 1, 128, 416) and batch["ctx_mask"].shape == (2, 1, 1, 128, 416)
        assert set(np.unique(batch["mask"].numpy())) == {0.0, 255.0}
        np.testing.assert_allclose(batch["intrinsics"][0].numpy(), _expected_intrinsics(128, 416), rtol=1e-6)
    else:  # a 352x704 random crop of 768x1920
        assert n == 1 and batch["img"].shape == (2, 3, 352, 704) and batch["depth"].shape == (2, 1, 352, 704)
        for K, md in zip(batch["intrinsics"].numpy(), batch["metadata"]):
            assert (K[0, 2], K[1, 2]) == pytest.approx(
                (WAYMO_CENTER[0] - md["rand_x_start"], WAYMO_CENTER[1] - 512 - md["rand_y_start"]), rel=1e-6)
        assert float(batch["depth"].max()) <= 80.0 and float((batch["depth"] > 0).float().mean()) > 0.001
    assert _assert_same_batches(jax_test_loader(cfg_j), build_test_loader(cfg_t), epochs=1) == 2
    test_batch = next(iter(build_test_loader(cfg_t)))
    assert test_batch["depth_orig"][0].shape == (1280, 1920)
    assert test_batch["img"].shape[-2:] == {"MonoDepth2": (192, 480), "MotionLearning": (128, 416),
                                            "Supervised": (768, 1920)}[family]


def test_crops_match_jax():
    """``CropTopTo`` 768 of 1280 rows and ``RandomCrop`` 352x704 of 768x1920, forward on
    a frame, its contexts, depth and mask, and backward on a prediction."""
    rng = np.random.default_rng(6)
    K = np.array([[WAYMO_FOCAL, 0, WAYMO_CENTER[0]], [0, WAYMO_FOCAL, WAYMO_CENTER[1]], [0, 0, 1]], np.float32)
    sample = {"img": rng.integers(0, 256, (1280, 1920, 3), dtype=np.uint8), "intrinsics": K,
              "ctx_img": [rng.integers(0, 256, (1280, 1920, 3), dtype=np.uint8)],
              "depth": rng.uniform(0, 80, (1280, 1920)).astype(np.float32),
              "mask": (rng.random((1280, 1920)) > 0.5).astype(np.float32), "metadata": {}}
    ops = [({"NAME": "CropTopTo", "IMG_H": 768}, (768, 1920)), ({"NAME": "RandomCrop", "IMG_H": 352, "IMG_W": 704},
                                                                (352, 704))]
    port, ref = dict(sample, metadata={}), dict(sample, metadata={})
    for fields, hw in ops:
        port = build_preprocess(CfgNode(fields)).forward(port, np.random.default_rng(7))
        ref = jax_build_preprocess(JaxCfgNode(fields)).forward(ref, np.random.default_rng(7))
        assert port["img"].shape[:2] == hw and port["metadata"] == ref["metadata"]
        for k in ("img", "intrinsics", "depth", "mask"):
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(port["ctx_img"][0], ref["ctx_img"][0])
    md = port["metadata"]
    assert md["crop_y_start"] == 512
    y0, x0 = 512 + md["rand_y_start"], md["rand_x_start"]
    np.testing.assert_array_equal(port["img"], sample["img"][y0:y0 + 352, x0:x0 + 704])
    assert (port["intrinsics"][0, 2], port["intrinsics"][1, 2]) == (K[0, 2] - x0, K[1, 2] - y0)
    pred = rng.uniform(1, 80, (352, 704)).astype(np.float32)
    back, back_ref = {"depth_pred": pred, "metadata": md}, {"depth_pred": pred, "metadata": dict(md)}
    for fields, _ in ops[::-1]:
        back = build_preprocess(CfgNode(fields)).backward(back)
        back_ref = jax_build_preprocess(JaxCfgNode(fields)).backward(back_ref)
    np.testing.assert_array_equal(back["depth_pred"], back_ref["depth_pred"])
    assert back["depth_pred"].shape == (1280, 1920) and back["depth_pred"][:512].max() == 0
    np.testing.assert_array_equal(back["depth_pred"][y0:y0 + 352, x0:x0 + 704], pred)


def _evaluate(evaluators, batches, preds, nhwc):
    for e in evaluators:
        e.reset()
    for batch, pred in zip(batches, preds):
        inputs = {"depth_orig": batch["depth_orig"], "metadata": batch["metadata"]}
        for e in evaluators:
            e.process(inputs, {"depth_pred": pred[..., None] if nhwc else pred[:, None]})
    out = {}
    for e in evaluators:
        out.update(e.evaluate() or {})
    return out


@pytest.mark.parametrize("family", ["MonoDepth2", "Supervised"])
def test_waymo_evaluation_matches_jax(tree, family, tmp_path):
    cfg_j, cfg_t = _waymo_cfgs(tree, family)
    assert bool(cfg_t.TEST.GT_SCALE) == (family == "MonoDepth2")
    batches = list(build_test_loader(cfg_t))
    rng = np.random.default_rng(8)
    # depth-like predictions at the pipeline's size, off by a per-frame scale (GT_SCALE undoes it)
    preds = [(rng.uniform(2.0, 60.0, (b["img"].shape[0], *b["img"].shape[-2:])) * (0.5 + i)).astype(np.float32)
             for i, b in enumerate(batches)]
    want = _evaluate(jax_build_evaluator(cfg_j, str(tmp_path / "jax")), batches, preds, nhwc=True)
    got = _evaluate(build_evaluator(cfg_t, str(tmp_path / "port")), batches, preds, nhwc=False)
    assert set(got) == set(want) == {"kitti evaluator", "kitti evaluator (0-30m)", "kitti evaluator (30-50m)",
                                     "kitti evaluator (50-80m)"}
    for tag, metrics in want.items():
        assert set(got[tag]) == set(metrics) and 0.0 < metrics["d3"] <= 1.0
        for k, v in metrics.items():
            np.testing.assert_allclose(got[tag][k], v, rtol=EVAL_RTOL, err_msg=f"{tag} {k}")
