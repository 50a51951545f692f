#!/usr/bin/env python
"""Single-image / directory depth inference demo on the PyTorch/CUDA port.

The twin of ``demo.py`` (which drives the JAX package): the config's test
preprocess, the model per image (``DefaultPredictor``: the checkpoint of
``MODEL.WEIGHTS`` or ``OUTPUT_DIR``), the preprocess undone to the original
frame, the depth coloured with magma under the frame, one panel per image.
PNG and JPEG frames are read as ``LoadImg`` reads them (``data/png.py``,
``data/jpeg.py``: by content, not by name) and the panels written as PNG
(``<frame name>.png``), without OpenCV; ``--video`` needs OpenCV (``cv2``) and
is refused where it does not import. It runs on the CUDA card; ``--device
cpu`` runs it on the CPU.

Usage:
  python tools/demo_torch.py --cfg <config.yaml> --input img_or_dir --output out_dir \
      MODEL.WEIGHTS <checkpoint>
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from simpledepthestimation_tpu_torch.config import get_cfg  # noqa: E402
from simpledepthestimation_tpu_torch.data.png import write_png  # noqa: E402
from simpledepthestimation_tpu_torch.data.preprocess.loading import LoadImg  # noqa: E402
from simpledepthestimation_tpu_torch.engine.trainer import DefaultPredictor  # noqa: E402
from simpledepthestimation_tpu_torch.models.build import resolve_device  # noqa: E402
from simpledepthestimation_tpu_torch.utils.colormap import magma_u8  # noqa: E402

JPEG = (".jpg", ".jpeg")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", required=True)
    p.add_argument("--input", required=True, help="image file or directory")
    p.add_argument("--output", default="demo_out")
    p.add_argument("--video", action="store_true", help="also write an mp4 (needs OpenCV)")
    p.add_argument("--fps", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device to run on (default: the CUDA card)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def _opencv():
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"demo_torch: --video needs OpenCV (cv2), which does not import here ({e}); "
                         "the panels need nothing more") from e
    return cv2


def main(argv=None):
    """Write one panel per input image into ``--output``; returns their paths."""
    args = parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.input, "*"))) if os.path.isdir(args.input) else [args.input]
    files = [f for f in files if f.lower().endswith((".png",) + JPEG)]
    if not files:
        raise SystemExit(f"demo_torch: no images found at {args.input}")
    cv2 = _opencv() if args.video else None
    device = resolve_device(args.device)

    cfg = get_cfg()
    cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(list(args.opts))
    cfg.freeze()
    predictor = DefaultPredictor(cfg, device=device)

    os.makedirs(args.output, exist_ok=True)
    frames, written = [], []
    for path in files:
        try:
            img = LoadImg._load(path)
        except ValueError as e:
            raise SystemExit(f"demo_torch: {e}") from e
        pred = predictor(img)

        norm = (pred - pred.min()) / (pred.max() - pred.min() + 1e-9)
        panel = np.concatenate([img, magma_u8(norm)], axis=0)
        out_path = os.path.join(args.output, os.path.splitext(os.path.basename(path))[0] + ".png")
        write_png(out_path, panel)
        frames.append(panel)
        written.append(out_path)
        print(f"wrote {out_path}")

    if args.video and len(frames) > 1:
        h, w = frames[0].shape[:2]
        video = os.path.join(args.output, "demo.mp4")
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (w, h))
        for fr in frames:
            vw.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
        vw.release()
        print(f"wrote {video}")
    return written


if __name__ == "__main__":
    main()
