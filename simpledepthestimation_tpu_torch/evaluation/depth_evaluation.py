"""KITTI depth metric suite; the port's copy of
``simpledepthestimation_tpu/evaluation/depth_evaluation.py`` (numpy on both
sides, so the metrics are the same to the last bits):
garg/eigen crops, the 9-metric error suite (silog, log10, abs_rel, sq_rel,
rms, log_rms, δ<1.25/1.25²/1.25³), per-sample inverse-preprocess → crop →
valid mask → optional median gt-scaling, cross-process metric gather, the
0-30/30-50/50-80 m banded variants, and the uint16 ×255 png depth saver.
"""

from __future__ import annotations

import itertools
import logging
import os
from typing import List, Tuple

import numpy as np

from ..data.png import write_png
from ..utils import comm
from .evaluator import DatasetEvaluator, EVALUATOR_REGISTRY

logger = logging.getLogger(__name__)


def garg_crop(pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    h, w = gt.shape[:2]
    ys = slice(int(0.40810811 * h), int(0.99189189 * h))
    xs = slice(int(0.03594771 * w), int(0.96405229 * w))
    return pred[ys, xs], gt[ys, xs]


def eigen_crop(pred: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    h, w = gt.shape[:2]
    ys = slice(int(0.3324324 * h), int(0.91351351 * h))
    xs = slice(int(0.0359477 * w), int(0.96405229 * w))
    return pred[ys, xs], gt[ys, xs]


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> Tuple[float, ...]:
    """The standard KITTI depth metrics over valid (masked) pixels."""
    thresh = np.maximum(gt / pred, pred / gt)
    d1 = float((thresh < 1.25).mean())
    d2 = float((thresh < 1.25**2).mean())
    d3 = float((thresh < 1.25**3).mean())

    rms = float(np.sqrt(((gt - pred) ** 2).mean()))
    log_rms = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))

    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))

    err = np.log(pred) - np.log(gt)
    # clamp: the variance can go infinitesimally negative on tiny valid sets
    silog = float(np.sqrt(max(np.mean(err**2) - np.mean(err) ** 2, 0.0) + 1e-8) * 100)
    log10 = float(np.mean(np.abs(np.log10(pred) - np.log10(gt))))

    return silog, log10, abs_rel, sq_rel, rms, log_rms, d1, d2, d3


@EVALUATOR_REGISTRY.register()
class kitti_evaluator(DatasetEvaluator):
    def __init__(self, cfg, output_folder):
        super().__init__(cfg)
        self._distributed = comm.get_world_size() > 1
        self.min_depth = 1e-3
        self.max_depth = 80.0
        self.garg_crop = True
        self.eigen_crop = False
        self.use_gt_scale = bool(cfg.TEST.get("GT_SCALE", False))
        self.tag = "kitti evaluator"
        self.metrics: List[Tuple[float, ...]] = []

    def reset(self):
        self.metrics = []

    def process(self, inputs, outputs):
        gts = np.asarray(inputs["depth_orig"])
        preds = np.asarray(outputs["depth_pred"])
        for gt, pred, metadata in zip(gts, preds, inputs["metadata"]):
            gt = np.squeeze(gt)
            pred = np.squeeze(pred)

            data = {"depth_pred": pred, "metadata": metadata}
            for postprocess in self.postprocesses:
                data = postprocess.backward(data)
            pred = data["depth_pred"]

            if self.garg_crop:
                pred, gt = garg_crop(pred, gt)
            elif self.eigen_crop:
                pred, gt = eigen_crop(pred, gt)

            # median scaling for self-supervised models (scale-ambiguous),
            # computed on the full 1e-3..80 band as the reference does
            valid = np.logical_and(gt > 1e-3, gt < 80)
            if self.use_gt_scale and valid.sum() > 0 and np.median(pred[valid]) > 0:
                pred = pred * np.median(gt[valid]) / np.median(pred[valid])

            valid = np.logical_and(gt > self.min_depth, gt < self.max_depth)
            if valid.sum() > 0:
                self.metrics.append(compute_errors(gt[valid], pred[valid]))

    def evaluate(self):
        if self._distributed:
            comm.synchronize()
            metric_rows = comm.gather(self.metrics, dst=0)
            if not comm.is_main_process():
                return {}
            metrics = list(itertools.chain(*metric_rows))
        else:
            metrics = self.metrics

        if not metrics:
            logger.warning("[kitti_evaluator] No valid predictions received.")
            return {}

        logger.info(f"{self.tag}{' w/ gt scale' if self.use_gt_scale else ''}")
        results = np.mean(metrics, axis=0)
        names = ("abs_rel", "sq_rel", "rms", "log_rms", "d1", "d2", "d3")
        logger.info(", ".join(f"{n:>7}" for n in names))
        logger.info(", ".join(f"{results[i]:7.3f}" for i in range(2, 9)))
        return {self.tag: dict(zip(names, (float(results[i]) for i in range(2, 9))))}


@EVALUATOR_REGISTRY.register()
class kitti_evaluator_0_30(kitti_evaluator):
    def __init__(self, cfg, output_folder):
        super().__init__(cfg, output_folder)
        self.min_depth, self.max_depth = 1e-3, 30.0
        self.tag = "kitti evaluator (0-30m)"


@EVALUATOR_REGISTRY.register()
class kitti_evaluator_30_50(kitti_evaluator):
    def __init__(self, cfg, output_folder):
        super().__init__(cfg, output_folder)
        self.min_depth, self.max_depth = 30.0, 50.0
        self.tag = "kitti evaluator (30-50m)"


@EVALUATOR_REGISTRY.register()
class kitti_evaluator_50_80(kitti_evaluator):
    def __init__(self, cfg, output_folder):
        super().__init__(cfg, output_folder)
        self.min_depth, self.max_depth = 50.0, 80.0
        self.tag = "kitti evaluator (50-80m)"


def write_depth(depth: np.ndarray, path: str) -> None:
    """uint16 ×255 PNG, the file ``cv2.imwrite`` writes for it."""
    write_png(path, (depth * 255).astype(np.uint16))


@EVALUATOR_REGISTRY.register()
class kitti_depth_saver(DatasetEvaluator):
    def __init__(self, cfg, output_folder):
        super().__init__(cfg)
        self.use_gt_scale = bool(cfg.TEST.get("GT_SCALE", False))
        self.output_folder = output_folder or "."

    def process(self, inputs, outputs):
        preds = np.asarray(outputs["depth_pred"])
        for pred, metadata in zip(preds, inputs["metadata"]):
            pred = np.squeeze(pred)
            data = {"depth_pred": pred, "metadata": metadata}
            for postprocess in self.postprocesses:
                data = postprocess.backward(data)
            pred = data["depth_pred"]

            if self.use_gt_scale and "depth_orig" in inputs:
                gt = np.squeeze(np.asarray(inputs["depth_orig"][0]))
                valid = np.logical_and(gt > 1e-3, gt < 80)
                if valid.sum() > 0 and np.median(pred[valid]) > 0:
                    pred = pred * np.median(gt[valid]) / np.median(pred[valid])

            name = "_".join(
                str(metadata.get(k, "")) for k in ("date", "drive", "img_id") if k in metadata
            ) or str(metadata.get("idx", "pred"))
            save_path = os.path.join(self.output_folder, f"{name}.png")
            os.makedirs(os.path.dirname(save_path), exist_ok=True)
            write_depth(pred, save_path)

    def evaluate(self):
        logger.info(
            f"depth saved to {self.output_folder}"
            f"{' w/ gt scale' if self.use_gt_scale else ''}"
        )
        return {}
