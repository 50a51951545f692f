#!/usr/bin/env python
"""Supervised depth regression (silog loss) on the PyTorch/CUDA port.

The twin of ``train.py`` (which drives the JAX package): AdamW with encoder
and decoder weight-decay groups and the poly rate decay, the BTS freeze rules
and ``TPU.REMAT`` where the config asks for them, a checkpoint each epoch,
periodic KITTI evaluation. It runs on the CUDA card; ``--device cpu`` runs it
on the CPU.

    python projects/Supervised/train_torch.py --cfg projects/Supervised/configs/bts_r50.yaml
    python projects/Supervised/train_torch.py --cfg ... --resume SOLVER.MAX_EPOCHS 51
    python projects/Supervised/train_torch.py --cfg ... --eval
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
