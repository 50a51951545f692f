#!/usr/bin/env python
"""Plain-loop training on the PyTorch/CUDA port (no hooks).

The twin of ``plain_train_net.py`` (which drives the JAX package): the epoch
loop of ``engine.runtime.do_train`` that the project entry points share. It
runs on the CUDA card; ``--device cpu`` runs it on the CPU.

Usage:
  python tools/plain_train_net_torch.py --cfg <config.yaml> [--eval] [--resume]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from simpledepthestimation_tpu_torch.engine import default_argument_parser, do_test, do_train, simple_main  # noqa: E402


def train(cfg, resume=False, device=None):
    return do_train(cfg, resume=resume, device=device)


def test(cfg, resume=False, device=None):
    return do_test(cfg, device=device)


def main(argv=None):
    return simple_main(default_argument_parser().parse_args(argv), train, test)


if __name__ == "__main__":
    main()
