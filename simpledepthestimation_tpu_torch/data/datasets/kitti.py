"""KITTI raw (eigen split) dataset; the port's copy of
``simpledepthestimation_tpu/data/datasets/kitti.py``:
eigen split txt parsing into (date, drive, cam, img_id) metadata, existence
filtering, temporal context windows (FORWARD/BACKWARD_CONTEXT × STRIDE with
same-drive consecutive-frame validation), calib parsing (P_rect_0x, R_rect_00,
velo/imu chains), OXTS GPS→SE(3) ground-truth pose, and the four depth types
(none / velodyne .npz / groundtruth / refined .png).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..build import DATASET_REGISTRY, DatasetBase
from ...geometry.pose import pose_from_oxts_packet_np, T_from_R_t_np

logger = logging.getLogger(__name__)


@DATASET_REGISTRY.register()
class KittiDepthV2(DatasetBase):
    def __init__(self, dataset_cfg, cfg):
        super().__init__(dataset_cfg, cfg)

        self.data_root = dataset_cfg.DATA_ROOT
        self.depth_root = dataset_cfg.get("DEPTH_ROOT", "")
        self.split_file = dataset_cfg.SPLIT

        self.depth_type = dataset_cfg.get("DEPTH_TYPE", "none")
        self.with_depth = self.depth_type != "none"
        self.use_cams = dataset_cfg.get("USE_CAMS", "image_02")

        self.forward_context = int(dataset_cfg.get("FORWARD_CONTEXT", 0))
        self.backward_context = int(dataset_cfg.get("BACKWARD_CONTEXT", 0))
        self.stride = int(dataset_cfg.get("STRIDE", 0))
        self.with_pose = bool(dataset_cfg.get("WITH_POSE", False))

        self.metadatas: List[Tuple[str, str, str, str]] = []
        count = 0
        with open(self.split_file) as f:
            for line in f:
                for entry in line.strip().split():
                    parts = entry.split("/")
                    date = parts[0]
                    drive = parts[1].replace(f"{date}_drive_", "").replace("_sync", "")
                    cam = parts[2]
                    img_id = parts[-1].replace(".png", "")
                    count += 1
                    if cam not in self.use_cams:
                        continue
                    if not os.path.isfile(self._img_path(date, drive, cam, img_id)):
                        continue
                    if self.with_depth and not os.path.isfile(
                        self._depth_path(date, drive, cam, img_id)
                    ):
                        continue
                    self.metadatas.append((date, drive, cam, img_id))

        self.metadatas.sort()
        logger.info(
            f"Loaded {count} samples; {len(self.metadatas)} after existence filtering"
        )

        # context window validation: neighbors must be consecutive frames of
        # the same (date, drive, cam)
        self.context_list: List[List[int]] = [[] for _ in self.metadatas]
        with_context = self.forward_context != 0 or self.backward_context != 0
        if with_context:
            self.valid_inds = []
            n_ctx = self.backward_context + self.forward_context
            for idx, (date, drive, cam, img_id) in enumerate(self.metadatas):
                for offset in range(
                    -self.backward_context * self.stride,
                    self.forward_context * self.stride + 1,
                    self.stride,
                ):
                    if offset == 0:
                        continue
                    j = idx + offset
                    if (
                        0 <= j < len(self.metadatas)
                        and self.metadatas[j][0] == date
                        and self.metadatas[j][1] == drive
                        and self.metadatas[j][2] == cam
                        and int(self.metadatas[j][3]) == int(img_id) + offset
                    ):
                        self.context_list[idx].append(j)
                if len(self.context_list[idx]) == n_ctx:
                    self.valid_inds.append(idx)
        else:
            self.valid_inds = list(range(len(self.metadatas)))

        logger.info(f"After context filtering, {len(self.valid_inds)} samples left")
        if not self.metadatas:
            logger.warning("Empty dataset!")
        self._calib_cache: Dict[str, Dict] = {}

    def __len__(self) -> int:
        return len(self.valid_inds)

    def get_sample(self, idx_: int, rng: Optional[np.random.Generator] = None):
        idx = self.valid_inds[idx_]
        date, drive, cam, img_id = self.metadatas[idx]

        data = {
            "metadata": {
                "idx": idx,
                "date": date,
                "drive": drive,
                "cam": cam,
                "img_id": img_id,
                "img_dir": self._img_path(date, drive, cam, img_id),
                "depth_dir": self._depth_path(date, drive, cam, img_id),
                "lidar_dir": self._lidar_path(date, drive, img_id),
                "ctx_img_dir": [
                    self._img_path(*self.metadatas[j]) for j in self.context_list[idx]
                ],
                "ctx_depth_dir": [
                    self._depth_path(*self.metadatas[j]) for j in self.context_list[idx]
                ],
                "ctx_lidar_dir": [
                    self._lidar_path(self.metadatas[j][0], self.metadatas[j][1], self.metadatas[j][3])
                    for j in self.context_list[idx]
                ],
            }
        }

        calib = self._calibs(date)
        Px = np.array(calib["cam"][f"P_rect_0{cam[-1]}"], np.float32).reshape(3, 4)
        data["intrinsics"] = Px[:3, :3].copy()

        if self.with_pose:
            R0 = np.eye(4, dtype=np.float32)
            R0[:3, :3] = np.array(calib["cam"]["R_rect_00"], np.float32).reshape(3, 3)
            velo2cam = T_from_R_t_np(calib["lidar"]["R"], calib["lidar"]["T"])
            imu2velo = T_from_R_t_np(calib["imu"]["R"], calib["imu"]["T"])
            imu2cam = R0 @ velo2cam @ imu2velo
            data["pose_gt"] = self._gt_pose(date, drive, img_id, imu2cam)

        return self.preprocess(data, rng)

    def __getitem__(self, idx: int):
        return self.get_sample(idx, None)

    # -- paths -------------------------------------------------------------
    def _img_path(self, date, drive, cam, img_id) -> str:
        return os.path.join(
            self.data_root, date, f"{date}_drive_{drive}_sync", cam, "data", f"{img_id}.png"
        )

    def _depth_path(self, date, drive, cam, img_id) -> str:
        if self.depth_type == "none":
            return ""
        if self.depth_type == "velodyne":
            return os.path.join(
                self.depth_root, date, f"{date}_drive_{drive}_sync",
                "proj_depth", "velodyne", cam, f"{img_id}.npz",
            )
        if self.depth_type == "groundtruth":
            return os.path.join(
                self.depth_root, date, f"{date}_drive_{drive}_sync",
                "proj_depth", "groundtruth", cam, f"{img_id}.png",
            )
        if self.depth_type == "refined":
            return os.path.join(
                self.depth_root, f"{date}_drive_{drive}_sync",
                "proj_depth", "groundtruth", cam, f"{img_id}.png",
            )
        raise NotImplementedError(self.depth_type)

    def _lidar_path(self, date, drive, img_id) -> str:
        return os.path.join(
            self.data_root, date, f"{date}_drive_{drive}_sync",
            "velodyne_points", "data", f"{img_id}.bin",
        )

    def _oxts_path(self, date, drive, img_id) -> str:
        return os.path.join(
            self.data_root, date, f"{date}_drive_{drive}_sync", "oxts", "data", f"{img_id}.txt"
        )

    # -- calib -------------------------------------------------------------
    def _calibs(self, date: str) -> Dict[str, Dict]:
        if date not in self._calib_cache:
            self._calib_cache[date] = {
                "cam": _read_calib(os.path.join(self.data_root, date, "calib_cam_to_cam.txt")),
                "lidar": _read_calib(os.path.join(self.data_root, date, "calib_velo_to_cam.txt")),
                "imu": _read_calib(os.path.join(self.data_root, date, "calib_imu_to_velo.txt")),
            }
        return self._calib_cache[date]

    def _gt_pose(self, date, drive, img_id, imu2cam) -> np.ndarray:
        """OXTS Mercator pose relative to frame 0, in the camera frame
        (reference kitti_v2.py:178-194)."""
        origin = np.loadtxt(self._oxts_path(date, drive, "0000000000"), delimiter=" ")
        scale = np.cos(origin[0] * np.pi / 180.0)
        origin_pose = T_from_R_t_np(*pose_from_oxts_packet_np(origin, scale))
        current = np.loadtxt(self._oxts_path(date, drive, img_id), delimiter=" ")
        pose = T_from_R_t_np(*pose_from_oxts_packet_np(current, scale))
        return (
            imu2cam @ np.linalg.inv(origin_pose) @ pose @ np.linalg.inv(imu2cam)
        ).astype(np.float32)


def _read_calib(filepath: str) -> Dict[str, np.ndarray]:
    data = {}
    with open(filepath) as f:
        for line in f:
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()], np.float32)
            except ValueError:
                pass  # date strings etc.
    return data
