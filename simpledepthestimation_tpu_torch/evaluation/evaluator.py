"""Evaluator framework and the timed inference loop; the port's copy of
``simpledepthestimation_tpu/evaluation/evaluator.py``.

Evaluators are selected by ``cfg.EVALUATORS``; each holds the test preprocess
list reversed, to bring predictions back to the original image frame.
``inference_on_dataset`` runs ``eval_fn`` over the loader with a warm-up and
times the compute around the copy of each prediction to the host (which waits
for the card).
"""

from __future__ import annotations

import datetime
import logging
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..utils.registry import Registry
from ..utils import comm
from ..utils.logger import log_every_n_seconds
from ..data.preprocess import build_preprocess

EVALUATOR_REGISTRY = Registry("EVALUATOR")

logger = logging.getLogger(__name__)


def build_evaluator(cfg, output_folder) -> List["DatasetEvaluator"]:
    evaluators = [
        EVALUATOR_REGISTRY.get(name)(cfg, output_folder) for name in cfg.EVALUATORS
    ]
    assert all(isinstance(e, DatasetEvaluator) for e in evaluators)
    return evaluators


class DatasetEvaluator:
    """Accumulates (inputs, outputs) pairs via ``process`` and summarizes
    via ``evaluate``. Holds the reversed test-preprocess list for
    prediction un-warping (reference evaluator.py:39-43)."""

    def __init__(self, cfg=None):
        self.postprocesses = []
        if cfg is not None:
            for pcfg in list(cfg.DATASETS.TEST.get("PREPROCESS", []))[::-1]:
                self.postprocesses.append(build_preprocess(pcfg))

    def reset(self):
        pass

    def process(self, inputs, outputs):
        pass

    def evaluate(self):
        pass


class DatasetEvaluators(DatasetEvaluator):
    def __init__(self, evaluators: List[DatasetEvaluator]):
        super().__init__(None)
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, inputs, outputs):
        for e in self._evaluators:
            e.process(inputs, outputs)

    def evaluate(self):
        results = OrderedDict()
        for evaluator in self._evaluators:
            result = evaluator.evaluate()
            if comm.is_main_process() and result is not None:
                for k, v in result.items():
                    assert k not in results, f"Duplicate evaluation key {k}"
                    results[k] = v
        return results


def inference_on_dataset(
    eval_fn: Callable[[dict], Any],
    data_loader,
    evaluator: Optional[DatasetEvaluator],
) -> Dict:
    """Run ``eval_fn`` (batch → ``depth_pred``, a numpy array or a tensor on any
    device) over the loader, feeding the evaluator: a 5-batch warm-up, then
    the compute time measured around the copy of the prediction to the host."""
    num_devices = comm.get_world_size()
    total = len(data_loader)
    logger.info(f"Start inference on {total} batches")

    if evaluator is None:
        evaluator = DatasetEvaluators([])
    evaluator.reset()

    num_warmup = min(5, total - 1)
    start_time = time.perf_counter()
    total_compute_time = 0.0

    for idx, inputs in enumerate(data_loader):
        if idx == num_warmup:
            start_time = time.perf_counter()
            total_compute_time = 0.0

        start_compute_time = time.perf_counter()
        depth_pred = eval_fn(inputs)
        if hasattr(depth_pred, "detach"):
            depth_pred = depth_pred.detach().cpu().numpy()  # waits for the card
        depth_pred = np.asarray(depth_pred)
        total_compute_time += time.perf_counter() - start_compute_time

        evaluator.process(inputs, {"depth_pred": depth_pred})

        iters_after_start = idx + 1 - num_warmup * int(idx >= num_warmup)
        seconds_per_img = total_compute_time / max(iters_after_start, 1)
        if idx >= num_warmup * 2 or seconds_per_img > 5:
            total_seconds_per_img = (time.perf_counter() - start_time) / max(
                iters_after_start, 1
            )
            eta = datetime.timedelta(
                seconds=int(total_seconds_per_img * (total - idx - 1))
            )
            log_every_n_seconds(
                logging.INFO,
                f"Inference done {idx + 1}/{total}. {seconds_per_img:.4f} s / img. ETA={eta}",
                n=5,
            )

    total_time = time.perf_counter() - start_time
    denom = max(total - num_warmup, 1)
    logger.info(
        f"Total inference time: {datetime.timedelta(seconds=total_time)} "
        f"({total_time / denom:.6f} s / img per device, on {num_devices} devices)"
    )
    logger.info(
        f"Total inference pure compute time: "
        f"{datetime.timedelta(seconds=int(total_compute_time))} "
        f"({total_compute_time / denom:.6f} s / img per device)"
    )

    results = evaluator.evaluate()
    return results if results is not None else {}
