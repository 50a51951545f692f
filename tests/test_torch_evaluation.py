"""The port's KITTI evaluation (``simpledepthestimation_tpu_torch/evaluation``)
against the JAX package's on shared seeded predictions and ground truth.

Both sides are numpy; limit: 1e-7 relative. The predictions are smaller
than the ground truth, so each evaluator runs the test preprocess list
backward (``Resize.backward``: OpenCV's INTER_NEAREST on the JAX side, its
numpy reproduction in the port) before the crop, the median scaling and the
metrics.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.evaluation import build_evaluator as jax_build_evaluator
from simpledepthestimation_tpu.evaluation import depth_evaluation as jax_de
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.evaluation import DatasetEvaluators, build_evaluator, inference_on_dataset
from simpledepthestimation_tpu_torch.evaluation import depth_evaluation as de

from torch_port_helpers import REPO

RTOL = 1e-7
EVALUATORS = ("kitti_evaluator", "kitti_evaluator_0_30", "kitti_evaluator_30_50", "kitti_evaluator_50_80")
GT_HW, PRED_HW = (75, 250), (32, 96)


def _cfgs(gt_scale):
    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(os.path.join(REPO, "projects", "MonoDepth2", "configs", "resnet18.yaml"))
        cfg.merge_from_list(["TEST.GT_SCALE", gt_scale, "EVALUATORS", EVALUATORS + ("kitti_depth_saver",)])
        out.append(cfg)
    return out


def _samples(seed=0, n=3):
    """Sparse ground truth in (0, 90) m (some beyond each band, zeros = no
    return) at GT_HW, predictions at PRED_HW off by a per-sample scale."""
    rng = np.random.default_rng(seed)
    gts, preds, metas = [], [], []
    for i in range(n):
        gt = rng.uniform(0.5, 90.0, GT_HW).astype(np.float32)
        gt[rng.random(GT_HW) < 0.6] = 0.0
        gts.append(gt)
        preds.append((rng.uniform(1.0, 80.0, PRED_HW) * (0.5 + i)).astype(np.float32))
        metas.append({"idx": i, "date": "2011_09_26", "drive": "0001", "img_id": f"{i:010d}",
                      "h_before_resize": GT_HW[0], "w_before_resize": GT_HW[1]})
    return gts, np.stack(preds), metas


def _run(evaluators, gts, preds, metas, batch=2):
    for e in evaluators:
        e.reset()
    for s in range(0, len(gts), batch):
        inputs = {"depth_orig": gts[s : s + batch], "metadata": metas[s : s + batch]}
        for e in evaluators:
            e.process(inputs, {"depth_pred": preds[s : s + batch]})
    out = {}
    for e in evaluators:
        out.update(e.evaluate() or {})
    return out


def test_compute_errors_and_crops_match_jax():
    rng = np.random.default_rng(1)
    gt = rng.uniform(1e-3, 80, 5000)
    pred = gt * rng.uniform(0.6, 1.5, 5000)
    np.testing.assert_allclose(de.compute_errors(gt, pred), jax_de.compute_errors(gt, pred), rtol=RTOL)
    for hw in [(375, 1242), (352, 1216), GT_HW]:
        p, g = rng.random(hw), rng.random(hw)
        for port, ref in ((de.garg_crop, jax_de.garg_crop), (de.eigen_crop, jax_de.eigen_crop)):
            for a, b in zip(port(p, g), ref(p, g)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gt_scale", [True, False], ids=["gt_scale", "no_gt_scale"])
def test_kitti_evaluators_match_jax(tmp_path, gt_scale):
    cfg_j, cfg_t = _cfgs(gt_scale)
    gts, preds, metas = _samples()
    want = _run(jax_build_evaluator(cfg_j, str(tmp_path / "jax")), gts, preds[..., None], metas)
    got = _run(build_evaluator(cfg_t, str(tmp_path / "port")), gts, preds[:, None], metas)  # NCHW
    assert set(got) == set(want) == {"kitti evaluator", "kitti evaluator (0-30m)", "kitti evaluator (30-50m)",
                                     "kitti evaluator (50-80m)"}
    for tag, metrics in want.items():
        assert set(got[tag]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(got[tag][k], v, rtol=RTOL, err_msg=f"{tag} {k}")
    # the depth saver's 16-bit PNG files: the port's reads back as the JAX package's
    for m in metas:
        name = f"{m['date']}_{m['drive']}_{m['img_id']}.png"
        a = cv2.imread(str(tmp_path / "port" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "jax" / name), cv2.IMREAD_UNCHANGED)
        assert a.dtype == np.uint16 and a.shape == GT_HW
        np.testing.assert_array_equal(a, b)


def test_inference_on_dataset_takes_tensors(tmp_path):
    _, cfg_t = _cfgs(True)
    gts, preds, metas = _samples(seed=2, n=2)
    loader = [{"depth_orig": [g], "metadata": [m], "img": torch.zeros(1, 3, *PRED_HW)} for g, m in zip(gts, metas)]
    calls = iter(torch.from_numpy(p[None, None]) for p in preds)
    evaluators = DatasetEvaluators([e for e in build_evaluator(cfg_t, str(tmp_path)) if e.__class__.__name__ == "kitti_evaluator"])
    results = inference_on_dataset(lambda batch: next(calls), loader, evaluators)
    want = _run(evaluators._evaluators, gts, preds[:, None], metas, batch=1)
    assert results == want
