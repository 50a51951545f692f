#!/usr/bin/env python
"""Hook-driven training on the PyTorch/CUDA port, with ``DefaultTrainer``.

The twin of ``train_net.py`` (which drives the JAX package): the config's
model, optimizer and loaders with the default hooks (timer, rate log,
PreciseBN with ``TEST.PRECISE_BN.ENABLED``, checkpoints, evaluation, a
``torch.profiler`` trace of each iteration in ``TPU.PROFILE_ITERS``, writers).
It runs on the CUDA card; ``--device cpu`` runs it on the CPU. Several
processes: ``--coordinator host:port --num-processes N --process-id i`` in
each, as for the project entry points.

Usage:
  python tools/train_net_torch.py --cfg projects/Supervised/configs/resnet18.yaml
  python tools/train_net_torch.py --cfg ... --eval MODEL.WEIGHTS <checkpoint dir or file>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from simpledepthestimation_tpu_torch.engine import (  # noqa: E402
    DefaultTrainer, assemble_cfg, default_argument_parser, default_setup, maybe_init_distributed,
    restore_inference_state,
)


def main(argv=None):
    """Train (or with ``--eval`` evaluate); returns the trainer or the results."""
    args = default_argument_parser().parse_args(argv)
    device = maybe_init_distributed(args)
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
