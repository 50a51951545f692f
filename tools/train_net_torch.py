#!/usr/bin/env python
"""Hook-driven training on the PyTorch/CUDA port, with ``DefaultTrainer``.

The twin of ``train_net.py`` (which drives the JAX package): the config's
model, optimizer and loaders with the default hooks (timer, rate log,
PreciseBN with ``TEST.PRECISE_BN.ENABLED``, checkpoints, evaluation, a
``torch.profiler`` trace of each iteration in ``TPU.PROFILE_ITERS``, writers).
It runs on the CUDA card; ``--device cpu`` runs it on the CPU.

Usage:
  python tools/train_net_torch.py --cfg projects/Supervised/configs/resnet18.yaml
  python tools/train_net_torch.py --cfg ... --eval MODEL.WEIGHTS <checkpoint dir or file>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from simpledepthestimation_tpu_torch.engine import (  # noqa: E402
    DefaultTrainer, assemble_cfg, default_argument_parser, default_setup, restore_inference_state,
)
from simpledepthestimation_tpu_torch.models.build import resolve_device  # noqa: E402


def main(argv=None):
    """Train (or with ``--eval`` evaluate); returns the trainer or the results."""
    args = default_argument_parser().parse_args(argv)
    if args.num_processes > 1 or args.coordinator:
        raise NotImplementedError("training in several processes is not ported yet: ROADMAP.md A17")
    device = resolve_device(args.device)
    cfg = assemble_cfg(args)
    default_setup(cfg, args)

    if args.eval:
        state, _ = restore_inference_state(cfg, device)
        results = DefaultTrainer.test(cfg, state)
        print(results)
        return results

    trainer = DefaultTrainer(cfg, device=device)
    trainer.resume_or_load(resume=args.resume)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
