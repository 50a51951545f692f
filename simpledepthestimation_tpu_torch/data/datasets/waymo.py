"""Waymo extracted-frames dataset: the port's copy of
``simpledepthestimation_tpu/data/datasets/waymo.py``, the same samples and
metadata from the same infos pickle.

Reads the infos pickle produced by tools/extract_waymo_data.py (frame index
+ per-segment calibration), DOWNSAMPLE subsampling (before the frames are
grouped by segment, so context frames are DOWNSAMPLE frames apart),
multi-camera USE_CAMS (one sample per camera, the camera innermost),
temporal context windows that lie whole within one segment.

Config keys mirror the reference's waymo configs
(projects/MonoDepth2/configs/Base_waymo.yaml): DATA_ROOT = image root
(``{rel_dir}/{cam}.jpg``), DEPTH_ROOT = depth root (``{cam}_depth.png``),
MASK_ROOT = mask root (``{cam}_mask.png``), SPLIT = path to the infos .pkl.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import List, Optional

import numpy as np

from ..build import DATASET_REGISTRY, DatasetBase

logger = logging.getLogger(__name__)


@DATASET_REGISTRY.register()
class WaymoDepth(DatasetBase):
    def __init__(self, dataset_cfg, cfg):
        super().__init__(dataset_cfg, cfg)
        self.data_root = dataset_cfg.DATA_ROOT
        self.depth_root = dataset_cfg.get("DEPTH_ROOT", "")
        self.mask_root = dataset_cfg.get("MASK_ROOT", "")
        self.infos_path = dataset_cfg.SPLIT
        self.use_cams = list(dataset_cfg.get("USE_CAMS", ["FRONT"]))
        self.downsample = int(dataset_cfg.get("DOWNSAMPLE", 1))
        self.forward_context = int(dataset_cfg.get("FORWARD_CONTEXT", 0))
        self.backward_context = int(dataset_cfg.get("BACKWARD_CONTEXT", 0))
        self.stride = int(dataset_cfg.get("STRIDE", 1))
        self.with_depth = bool(dataset_cfg.get("WITH_DEPTH", False))

        with open(self.infos_path, "rb") as f:
            infos = pickle.load(f)
        frames = infos["frames"] if isinstance(infos, dict) else infos
        if self.downsample > 1:
            frames = frames[:: self.downsample]
        self._frames = frames

        by_segment: dict = {}
        for i, fr in enumerate(frames):
            by_segment.setdefault(fr["segment"], []).append(i)

        self.samples: List[dict] = []
        for seg, idxs in by_segment.items():
            for pos, i in enumerate(idxs):
                lo = pos - self.backward_context * self.stride
                hi = pos + self.forward_context * self.stride
                if lo < 0 or hi >= len(idxs):
                    continue
                ctx = [idxs[p] for p in range(lo, hi + 1, self.stride) if p != pos]
                for cam in self.use_cams:
                    self.samples.append({"frame": i, "cam": cam, "ctx_frames": ctx})
        logger.info(
            f"WaymoDepth: {len(self.samples)} samples from {len(frames)} frames "
            f"({len(by_segment)} segments, cams={self.use_cams})"
        )

    def __len__(self) -> int:
        return len(self.samples)

    def _img_path(self, frame_info, cam) -> str:
        return os.path.join(self.data_root, frame_info["rel_dir"], f"{cam}.jpg")

    def _depth_path(self, frame_info, cam) -> str:
        if not self.depth_root:
            return ""
        return os.path.join(self.depth_root, frame_info["rel_dir"], f"{cam}_depth.png")

    def _mask_path(self, frame_info, cam) -> str:
        if not self.mask_root:
            return ""
        return os.path.join(self.mask_root, frame_info["rel_dir"], f"{cam}_mask.png")

    def get_sample(self, idx: int, rng: Optional[np.random.Generator] = None):
        sample = self.samples[idx]
        frame_info = self._frames[sample["frame"]]
        cam = sample["cam"]

        data = {
            "metadata": {
                "idx": idx,
                "img_id": str(sample["frame"]),
                "cam": cam,
                "img_dir": self._img_path(frame_info, cam),
                "depth_dir": self._depth_path(frame_info, cam) if self.with_depth else "",
                "ctx_img_dir": [
                    self._img_path(self._frames[j], cam) for j in sample["ctx_frames"]
                ],
                "ctx_depth_dir": [
                    self._depth_path(self._frames[j], cam) for j in sample["ctx_frames"]
                ],
                "mask_dir": self._mask_path(frame_info, cam),
                "ctx_mask_dir": [
                    self._mask_path(self._frames[j], cam) for j in sample["ctx_frames"]
                ],
            },
            "intrinsics": np.asarray(
                frame_info["calib"][cam]["intrinsics"], np.float32
            ).copy(),
        }
        return self.preprocess(data, rng)

    def __getitem__(self, idx: int):
        return self.get_sample(idx, None)
