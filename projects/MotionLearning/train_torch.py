#!/usr/bin/env python
"""MotionLearning (unsupervised depth and motion) training on the PyTorch/CUDA port.

The twin of ``train.py`` (which drives the JAX package): Adam (depth and pose
groups, eps 1e-7) with MultiStepLR, gradient-norm clipping (``SOLVER.GRAD_CLIP``),
the RandLayerNorm noise ramp ``NOISE_STDDEV·min(step/RAMPUP_ITERS, 1)²`` and
the motion burn-in weight ``clip(2·step/BURN_IN_ITERS − 1, 0, 1)``, with step
``i`` (from 0) trained under ``step = i + 1`` as in ``train.py``; a resumed run
counts on from the restored ``TrainState.step``. It runs on the CUDA card;
``--device cpu`` runs it on the CPU.

    python projects/MotionLearning/train_torch.py --cfg projects/MotionLearning/configs/synthetic_quick.yaml
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from simpledepthestimation_tpu_torch.engine import default_argument_parser, do_test, do_train, simple_main  # noqa: E402
from simpledepthestimation_tpu_torch.models import make_schedule_fn  # noqa: E402


def train(cfg, resume=False, device=None):
    return do_train(cfg, resume=resume, schedule_fn=make_schedule_fn(cfg), device=device)


def test(cfg, resume=False, device=None):
    return do_test(cfg, device=device)


if __name__ == "__main__":
    simple_main(default_argument_parser().parse_args(), train, test)
