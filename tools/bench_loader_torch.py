#!/usr/bin/env python
"""Host input-pipeline throughput of the PyTorch/CUDA port's loader.

The twin of ``bench_loader.py`` (which drives the JAX package's loader): it
fabricates the same KITTI-shaped tree (64 frames of 1242x375 PNG, one noise
frame rolled sideways 7 pixels a frame, written by OpenCV's ``cv2.imwrite``),
runs the MonoDepth2 train preprocess chain (``KittiDepthV2``: LoadImg with both
contexts, Resize 640x192, RandomFlip, RandomImageAug, ToTensor) at
``IMS_PER_BATCH`` 24, and measures images per second out of the loader for 2,
4, 8 and 16 worker threads: one warm epoch, then two measured. It also times
the port's PNG reader on one frame as OpenCV wrote it (rows with the sub,
average and Paeth filters) and on the same pixels written by the port's own
writer (filter 0 rows). OpenCV is needed to write the tree, as in the JAX
tool, and the tool refuses to run where ``cv2`` does not import: the port's
writer would make a different tree, one its reader takes faster. Nothing
here uses the card.

The tree goes under the temporary directory (``$TMPDIR``).

Usage:
  python tools/bench_loader_torch.py
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

WORKERS = (2, 4, 8, 16)
READ_REPEATS = 5


def _opencv():
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"bench_loader_torch: writing the tree needs OpenCV (cv2), which does not import here "
                         f"({e}); the port's own PNG writer would measure another, faster reader path") from e
    return cv2


def make_tree(root, n=64, H=375, W=1242):
    """The JAX tool's KITTI tree under ``root``: returns the split file."""
    cv2 = _opencv()
    date, drive, cam = "2011_09_26", "0001", "image_02"
    rng = np.random.RandomState(0)
    drive_dir = os.path.join(root, "raw", date, f"{date}_drive_{drive}_sync", cam, "data")
    os.makedirs(drive_dir, exist_ok=True)
    base = rng.randint(0, 255, (H, W, 3), np.uint8)
    for i in range(n):
        cv2.imwrite(os.path.join(drive_dir, f"{i:010d}.png"), np.roll(base, i * 7, 1))
    with open(os.path.join(root, "raw", date, "calib_cam_to_cam.txt"), "w") as f:
        f.write("P_rect_02: 700.0 0.0 620.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0\n")
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
    for name in ("calib_velo_to_cam.txt", "calib_imu_to_velo.txt"):
        with open(os.path.join(root, "raw", date, name), "w") as f:
            f.write("R: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n")
    split = os.path.join(root, "split.txt")
    with open(split, "w") as f:
        for i in range(n):
            f.write(f"{date}/{date}_drive_{drive}_sync/{cam}/data/{i:010d}.png\n")
    return split


def loader_cfg(root, split, workers, batch=24):
    """The JAX tool's loader config on the port."""
    from simpledepthestimation_tpu_torch.config import CfgNode, get_cfg

    cfg = get_cfg()
    t = cfg.DATASETS.TRAIN
    t.NAME = "KittiDepthV2"
    t.DATA_ROOT = os.path.join(root, "raw")
    t.DEPTH_ROOT = ""
    t.SPLIT = split
    t.DEPTH_TYPE = "none"
    t.FORWARD_CONTEXT = 1
    t.BACKWARD_CONTEXT = 1
    t.STRIDE = 1
    t.PREPROCESS = [
        CfgNode({"NAME": "LoadImg", "WITH_CTX": True}),
        CfgNode({"NAME": "Resize", "IMG_W": 640, "IMG_H": 192}),
        CfgNode({"NAME": "RandomFlip"}),
        CfgNode({"NAME": "RandomImageAug"}),
        CfgNode({"NAME": "ToTensor"}),
    ]
    cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.DATALOADER.NUM_WORKERS = workers
    return cfg


def images_per_s(root, split, workers, epochs=2, warm_epochs=1):
    """``warm_epochs`` unmeasured (the page cache), then ``epochs`` measured: images a second."""
    from simpledepthestimation_tpu_torch.data import build_train_loader

    loader = build_train_loader(loader_cfg(root, split, workers), seed=0)
    for _ in range(warm_epochs):
        for _ in loader:
            pass
    n_img = 0
    t0 = time.perf_counter()
    for epoch in range(1, epochs + 1):
        loader.set_epoch(epoch)
        for batch in loader:
            n_img += batch["img"].shape[0]
    return n_img / (time.perf_counter() - t0)


def frame_read_ms(split, root, repeats=READ_REPEATS):
    """The port's PNG reader on the tree's first frame (OpenCV's filtered rows)
    and on the same pixels written by the port's writer (filter 0): ms a read,
    the least of ``repeats``."""
    from simpledepthestimation_tpu_torch.data.png import read_png, write_png

    with open(split) as f:
        first = os.path.join(root, "raw", f.readline().strip())
    own = os.path.join(root, "port_written.png")
    write_png(own, read_png(first))

    def best_ms(path):
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            read_png(path)
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    return {"opencv_written_ms": best_ms(first), "port_written_ms": best_ms(own)}


def main(argv=None):
    """Prints the frame read times and one line per worker count; returns
    ``{"read": frame_read_ms(...), "images_per_s": {workers: rate}}``."""
    argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter).parse_args(argv)
    root = os.path.join(tempfile.gettempdir(), "bench_loader_kitti_torch")
    split = make_tree(root, n=64)
    read = frame_read_ms(split, root)
    print(f"PNG read, 1242x375 frame: {read['opencv_written_ms']:.1f} ms as OpenCV wrote it, "
          f"{read['port_written_ms']:.1f} ms as the port writes it", flush=True)
    rates = {}
    for workers in WORKERS:
        rates[workers] = images_per_s(root, split, workers)
        print(f"workers={workers:2d}: {rates[workers]:7.1f} img/s host decode+augment", flush=True)
    return {"read": read, "images_per_s": rates}


if __name__ == "__main__":
    main()
