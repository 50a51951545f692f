"""File-loading preprocess ops: ``LoadImg`` (RGB uint8), ``LoadDepth``
(velodyne ``.npz`` or 16-bit ``.png`` / 255, optionally kept at full size for
evaluation), ``LoadMask`` and ``LoadLidar``.

The port's copy of ``simpledepthestimation_tpu/data/preprocess/loading.py``,
with files read by ``data/png.py`` and ``data/jpeg.py`` in place of
``cv2.imread``: the same arrays (``imread`` gives BGR, which the JAX package
turns into RGB; the readers give RGB directly). A frame's format is told by
its first bytes, as ``imread`` tells it, not by its name; depth maps and
masks are PNG only.
"""

from __future__ import annotations

import os

import numpy as np

from .. import jpeg, png
from .build import PREPROCESS_REGISTRY, Preprocess


def _read_gray(path: str) -> np.ndarray:
    """A one-channel PNG as stored (``cv2.imread(path, -1)`` of a depth map or a mask)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} does not exist!")
    img = png.read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: expected a one-channel PNG, got {img.shape[2]} channels")
    return img


@PREPROCESS_REGISTRY.register()
class LoadImg(Preprocess):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.load_ctx = cfg.get("WITH_CTX", False)

    @staticmethod
    def _load(path: str) -> np.ndarray:
        """An 8-bit RGB frame (``cv2.imread`` + BGR→RGB) of a PNG or JPEG
        file: gray is repeated to three channels and alpha dropped, as
        ``imread`` does."""
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path} does not exist!")
        with open(path, "rb") as f:
            head = f.read(len(png.SIGNATURE))
        if head.startswith(jpeg.SIGNATURE):
            return jpeg.read_jpeg(path)
        if not head.startswith(png.SIGNATURE):
            raise ValueError(f"{path} is neither a PNG nor a JPEG file")
        img = png.read_png(path)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: a 16-bit colour frame is not supported")
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])

    def forward(self, data_dict, rng=None):
        data_dict["img"] = self._load(data_dict["metadata"]["img_dir"])
        if self.load_ctx:
            data_dict["ctx_img"] = [self._load(p) for p in data_dict["metadata"]["ctx_img_dir"]]
        return data_dict


@PREPROCESS_REGISTRY.register()
class LoadDepth(Preprocess):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.load_ctx = cfg.get("WITH_CTX", False)
        self.keep_orig_for_eval = cfg.get("KEEP_ORIG", False)

    @staticmethod
    def _load(path: str) -> np.ndarray:
        ext = os.path.splitext(path)[-1]
        if ext == ".npz":
            return np.load(path)["velodyne_depth"].astype(np.float32)
        if ext == ".png":
            return _read_gray(path).astype(np.float32) / 255.0
        raise NotImplementedError(f"Unsupported depth format {ext}")

    def forward(self, data_dict, rng=None):
        data_dict["depth"] = self._load(data_dict["metadata"]["depth_dir"])
        if self.keep_orig_for_eval:
            data_dict["depth_orig"] = data_dict["depth"].copy()
        if self.load_ctx:
            data_dict["ctx_depth"] = [self._load(p) for p in data_dict["metadata"]["ctx_depth_dir"]]
        return data_dict


@PREPROCESS_REGISTRY.register()
class LoadMask(Preprocess):
    @staticmethod
    def _load(path: str) -> np.ndarray:
        return _read_gray(path).astype(np.float32)

    def forward(self, data_dict, rng=None):
        data_dict["mask"] = self._load(data_dict["metadata"]["mask_dir"])
        data_dict["ctx_mask"] = [self._load(p) for p in data_dict["metadata"]["ctx_mask_dir"]]
        return data_dict


@PREPROCESS_REGISTRY.register()
class LoadLidar(Preprocess):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.load_ctx = cfg.get("WITH_CTX", False)
        self.load_dim = cfg.get("LOAD_DIM", 4)
        self.use_dim = cfg.get("USE_DIM", 3)

    def _load(self, path: str) -> np.ndarray:
        ext = os.path.splitext(path)[-1]
        if ext != ".bin":
            raise NotImplementedError(f"Unsupported lidar format {ext}")
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, self.load_dim)
        if isinstance(self.use_dim, int):
            return scan[:, : self.use_dim]
        return scan[:, list(self.use_dim)]

    def forward(self, data_dict, rng=None):
        data_dict["lidar"] = self._load(data_dict["metadata"]["lidar_dir"])
        if self.load_ctx:
            data_dict["ctx_lidar"] = [self._load(p) for p in data_dict["metadata"]["ctx_lidar_dir"]]
        return data_dict
