"""Procedural synthetic depth dataset: the port's copy of
``simpledepthestimation_tpu/data/datasets/synthetic.py``, the same scenes from
the same seeds.

Deterministic 'wall, floor and boxes' scenes with ground-truth depth,
contexts made by sideways pixel shifts (so the photometric loss has signal)
and calibrated intrinsics, in KittiDepthV2's sample schema, so the whole
pipeline (preprocess → collate → train → evaluation's inverse transforms)
runs as on KITTI.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..build import DATASET_REGISTRY, DatasetBase


def _scene(rng: np.random.Generator, H: int, W: int):
    """A textured fronto-parallel 'wall + floor + boxes' scene: returns
    (rgb uint8 [H,W,3], depth float32 [H,W])."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    depth = np.full((H, W), 30.0, np.float32)
    # floor ramp in the lower half
    floor = yy > H // 2
    depth[floor] = 30.0 - 25.0 * (yy[floor] - H // 2) / (H // 2)
    # random boxes at random depths
    for _ in range(6):
        bw, bh = int(rng.integers(W // 8, W // 3)), int(rng.integers(H // 8, H // 3))
        x0 = int(rng.integers(0, W - bw))
        y0 = int(rng.integers(0, H - bh))
        depth[y0 : y0 + bh, x0 : x0 + bw] = float(rng.uniform(3.0, 20.0))
    # texture: smooth noise + gradient, depth-correlated shading
    tex = rng.random((H // 8 + 1, W // 8 + 1, 3)).repeat(8, 0).repeat(8, 1)[:H, :W]
    shade = (1.0 - depth[..., None] / 40.0) * 0.5 + 0.25
    rgb = np.clip(tex * 0.5 + shade, 0, 1)
    return (rgb * 255).astype(np.uint8), depth


@DATASET_REGISTRY.register()
class SyntheticDepth(DatasetBase):
    def __init__(self, dataset_cfg, cfg):
        super().__init__(dataset_cfg, cfg)
        self.length = int(dataset_cfg.get("LENGTH", 64))
        self.H = int(dataset_cfg.get("IMG_HEIGHT", 192))
        self.W = int(dataset_cfg.get("IMG_WIDTH", 640))
        self.num_contexts = int(dataset_cfg.get("FORWARD_CONTEXT", 0)) + int(
            dataset_cfg.get("BACKWARD_CONTEXT", 0)
        )
        self.with_depth = dataset_cfg.get("DEPTH_TYPE", "synthetic") != "none"
        self.seed = int(dataset_cfg.get("SEED", 0))

    def __len__(self) -> int:
        return self.length

    def get_sample(self, idx: int, rng: Optional[np.random.Generator] = None):
        scene_rng = np.random.default_rng(self.seed * 100003 + idx)
        H, W = self.H, self.W
        rgb, depth = _scene(scene_rng, H, W)

        fx = fy = 0.58 * W
        K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)

        data = {
            "metadata": {"idx": idx, "img_id": str(idx), "img_dir": "", "depth_dir": ""},
            "img": rgb,
            "intrinsics": K,
        }
        if self.with_depth:
            data["depth"] = depth
            data["depth_orig"] = depth.copy()

        if self.num_contexts:
            # contexts: horizontal pixel shifts approximating small camera
            # translations (disparity signal for the photometric loss)
            ctx = []
            for j in range(self.num_contexts):
                shift = (j + 1) * (3 if j % 2 == 0 else -3)
                ctx.append(np.roll(rgb, shift, axis=1))
            data["ctx_img"] = ctx

        return self.preprocess(data, rng)

    def __getitem__(self, idx: int):
        return self.get_sample(idx, None)
