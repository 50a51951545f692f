#!/usr/bin/env python
"""Export a trained depth model of the PyTorch/CUDA port to a serving artifact
(``torch.export``, weights in the program), loadable with
``simpledepthestimation_tpu_torch.engine.export.load_exported`` without the
model's code. Input NCHW ``[B,3,H,W]`` float32, output ``[B,1,H,W]``; a
``.json`` sidecar beside the artifact says so.

The twin of ``export_inference.py`` (which drives the JAX package). It exports
on the CUDA card; ``--device cpu`` exports for the CPU.

Usage:
  python tools/export_inference_torch.py --cfg projects/Supervised/configs/resnet18.yaml \
      --output model.pt2 [--batch 1] [MODEL.WEIGHTS <checkpoint>] [KEY VALUE ...]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from simpledepthestimation_tpu_torch.engine.defaults import assemble_cfg, default_setup  # noqa: E402
from simpledepthestimation_tpu_torch.engine.export import export_inference  # noqa: E402
from simpledepthestimation_tpu_torch.models.build import resolve_device  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", required=True)
    p.add_argument("--output", required=True, help="artifact path (e.g. model.pt2)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--allow-random-init", action="store_true",
                   help="export even when no checkpoint is found (smoke testing)")
    p.add_argument("--device", default="cuda", help="torch device to export on (default: the CUDA card)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    args.resume = False

    device = resolve_device(args.device)
    cfg = assemble_cfg(args)
    default_setup(cfg, args)
    path = export_inference(cfg, args.output, batch=args.batch, allow_random_init=args.allow_random_init,
                            device=device)
    print(f"exported: {path}")
    return path


if __name__ == "__main__":
    main()
