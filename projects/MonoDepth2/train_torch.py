#!/usr/bin/env python
"""MonoDepth2 self-supervised training on the PyTorch/CUDA port.

The twin of ``train.py`` (which drives the JAX package): Adam with depth and
pose rate groups and MultiStepLR, the photometric min-reprojection loss,
a checkpoint each epoch, periodic KITTI evaluation with median gt-scaling.
It runs on the CUDA card; ``--device cpu`` runs it on the CPU.

    python projects/MonoDepth2/train_torch.py --cfg projects/MonoDepth2/configs/synthetic_quick.yaml
    python projects/MonoDepth2/train_torch.py --cfg ... --resume SOLVER.MAX_EPOCHS 3
    python projects/MonoDepth2/train_torch.py --cfg ... --eval
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from simpledepthestimation_tpu_torch.engine import default_argument_parser, do_test, do_train, simple_main  # noqa: E402


def train(cfg, resume=False, device=None):
    return do_train(cfg, resume=resume, device=device)


def test(cfg, resume=False, device=None):
    return do_test(cfg, device=device)


if __name__ == "__main__":
    simple_main(default_argument_parser().parse_args(), train, test)
