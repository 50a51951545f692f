"""Geometric and photometric preprocess ops with exact inverses.

The port's copy of ``simpledepthestimation_tpu/data/preprocess/augmentation.py``:
KBCrop, CropTopTo, Resize (bilinear frames, sparse depth scatter, intrinsics
rescale; invertible), RandomCrop, RandomFlip (a flag: the depth net flips),
ClipDepth, and RandomImageAug (brightness, contrast, saturation and hue
jitter in a random order, the same for the target and its contexts, keeping
the unjittered ``img_orig`` / ``ctx_img_orig`` for the photometric loss).

The JAX package runs these on OpenCV; this package imports no OpenCV, and
reproduces in numpy the arithmetic of the OpenCV calls it replaces, so that
its frames are byte-equal to the JAX package's:

- ``cv2.resize`` ``INTER_LINEAR`` on uint8 (:func:`resize_linear_u8`):
  half-pixel centres, border clamping, 11-bit integer weights, and the
  vertical pass in OpenCV's vectorised form (each row sum shifted right by 4,
  the high 16 bits of its product with the weight, a rounding shift by 2);
- ``cv2.resize`` ``INTER_NEAREST`` (:func:`resize_nearest`): source index
  ``floor(dst · (1 / (dst_size / src_size)))``, which is not PyTorch's
  ``nearest`` or ``nearest-exact``;
- the float32 jitter: ``addWeighted`` as ``fma(a, α, fma(b, β, γ))``, the gray
  ``transform`` as ``fma(b, w_b, fma(r, w_r, g·w_g))``, RGB↔HSV with H in
  degrees and the fused forms of OpenCV's vector code, ``mean`` accumulated in
  float64, and ``convertScaleAbs`` rounding |255·x| half to even with
  saturation. A fused multiply-add of float32 operands is taken in float64,
  where the product is exact, and rounded once to float32.

Measured against OpenCV 5.0 on an x86-64 CPU with AVX-512: the float32
intermediates are bit-equal wherever the pixel count of a call is a multiple
of 16; at the last pixels of a row whose width is not, OpenCV's scalar tail
code rounds differently in the last bit at a few pixels, which did not change
a single uint8 output in 300 random frames (``tests/test_torch_data.py``).
"""

from __future__ import annotations

import numpy as np

from .build import PREPROCESS_REGISTRY, Preprocess


_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Source indices and 11-bit weights of OpenCV's INTER_LINEAR along one axis.
    The horizontal pass clamps the weights at the border (weight 1 on the edge
    pixel); the vertical pass keeps them and clamps the row indices."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        lo, hi = s < 0, s >= src - 1
        f[lo | hi] = 0.0
        s[lo] = 0
        s[hi] = src - 1
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)`` of a uint8
    [H, W] or [H, W, C] image, byte for byte."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_u8 takes uint8 frames, not {img.dtype}")
    H, W = img.shape[:2]
    if (H, W) == (dh, dw):
        return img.copy()
    x0, x1, a0, a1 = _linear_taps(W, dw, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(H, dh, clamp_weights=False)
    src = img.astype(np.int64).reshape(H, W, -1)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]  # [H, dw, C], 22-bit
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((rows[y0] >> 4) * b0 >> 16) + ((rows[y1] >> 4) * b1 >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((dh, dw) + img.shape[2:])


def resize_nearest(a: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """``cv2.resize(a, (dw, dh), interpolation=cv2.INTER_NEAREST)``, any dtype."""
    H, W = a.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / W))).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / H))).astype(np.int64), H - 1)
    return a[ys][:, xs]




def resize_depth_sparse(depth: np.ndarray, dst_hw) -> np.ndarray:
    """Resize a sparse depth map by scattering the nonzero points to their
    scaled integer locations (reference augmentation.py:14-23) — bilinear
    interpolation would smear lidar returns across empty pixels."""
    H, W = depth.shape
    dh, dw = dst_hw
    if (H, W) == (dh, dw):
        return depth
    y, x = np.nonzero(depth)
    out = np.zeros((dh, dw), dtype=np.float32)
    out[(dh * y / H).astype(np.int64), (dw * x / W).astype(np.int64)] = depth[y, x]
    return out


def _crop_all(data_dict, y0: int, y1: int, x0: int, x1: int) -> None:
    data_dict["img"] = data_dict["img"][y0:y1, x0:x1]
    if "intrinsics" in data_dict:
        K = data_dict["intrinsics"].copy()
        K[0, 2] -= x0
        K[1, 2] -= y0
        data_dict["intrinsics"] = K
    for key in ("depth", "mask"):
        if key in data_dict:
            data_dict[key] = data_dict[key][y0:y1, x0:x1]
    for key in ("ctx_img", "ctx_depth", "ctx_mask"):
        if key in data_dict:
            data_dict[key] = [a[y0:y1, x0:x1] for a in data_dict[key]]


@PREPROCESS_REGISTRY.register()
class KBCrop(Preprocess):
    """Fixed 1216×352 bottom-center crop (the BTS/KITTI convention)."""

    WIDTH, HEIGHT = 1216, 352

    def forward(self, data_dict, rng=None):
        img_h, img_w = data_dict["img"].shape[:2]
        x_start = int((img_w - self.WIDTH) / 2)
        y_start = int(img_h - self.HEIGHT)
        _crop_all(data_dict, y_start, y_start + self.HEIGHT, x_start, x_start + self.WIDTH)
        md = data_dict["metadata"]
        md["kb_y_start"], md["kb_x_start"] = y_start, x_start
        md["h_before_kb_crop"], md["w_before_kb_crop"] = img_h, img_w
        return data_dict

    def backward(self, data_dict):
        pred = data_dict["depth_pred"]
        md = data_dict["metadata"]
        out = np.zeros((md["h_before_kb_crop"], md["w_before_kb_crop"]), np.float32)
        y0, x0 = md["kb_y_start"], md["kb_x_start"]
        out[y0 : y0 + pred.shape[-2], x0 : x0 + pred.shape[-1]] = pred
        data_dict["depth_pred"] = out
        return data_dict


@PREPROCESS_REGISTRY.register()
class CropTopTo(Preprocess):
    """Crop away the top rows so the image is cfg.IMG_H tall."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.height = cfg["IMG_H"]

    def forward(self, data_dict, rng=None):
        img_h, img_w = data_dict["img"].shape[:2]
        y_start = int(img_h - self.height)
        _crop_all(data_dict, y_start, img_h, 0, img_w)
        md = data_dict["metadata"]
        md["crop_y_start"] = y_start
        md["h_before_crop"], md["w_before_crop"] = img_h, img_w
        return data_dict

    def backward(self, data_dict):
        pred = data_dict["depth_pred"]
        md = data_dict["metadata"]
        out = np.zeros((md["h_before_crop"], md["w_before_crop"]), np.float32)
        out[md["crop_y_start"] :] = pred
        data_dict["depth_pred"] = out
        return data_dict


@PREPROCESS_REGISTRY.register()
class Resize(Preprocess):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.img_h = cfg["IMG_H"]
        self.img_w = cfg["IMG_W"]

    def forward(self, data_dict, rng=None):
        H, W = data_dict["img"].shape[:2]
        dw, dh = self.img_w, self.img_h
        data_dict["img"] = resize_linear_u8(data_dict["img"], dw, dh)
        if "intrinsics" in data_dict:
            K = data_dict["intrinsics"].copy()
            K[0, 0] *= dw / W
            K[0, 2] *= dw / W
            K[1, 1] *= dh / H
            K[1, 2] *= dh / H
            data_dict["intrinsics"] = K
        if "depth" in data_dict:
            data_dict["depth"] = resize_depth_sparse(data_dict["depth"], (dh, dw))
        if "mask" in data_dict:
            data_dict["mask"] = resize_nearest(data_dict["mask"], dw, dh)
        if "ctx_img" in data_dict:
            data_dict["ctx_img"] = [resize_linear_u8(a, dw, dh) for a in data_dict["ctx_img"]]
        if "ctx_depth" in data_dict:
            data_dict["ctx_depth"] = [
                resize_depth_sparse(a, (dh, dw)) for a in data_dict["ctx_depth"]
            ]
        if "ctx_mask" in data_dict:
            data_dict["ctx_mask"] = [resize_nearest(a, dw, dh) for a in data_dict["ctx_mask"]]
        md = data_dict["metadata"]
        md["h_before_resize"], md["w_before_resize"] = H, W
        return data_dict

    def backward(self, data_dict):
        md = data_dict["metadata"]
        data_dict["depth_pred"] = resize_nearest(
            data_dict["depth_pred"], md["w_before_resize"], md["h_before_resize"]
        )
        return data_dict


@PREPROCESS_REGISTRY.register()
class RandomCrop(Preprocess):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.img_h = cfg["IMG_H"]
        self.img_w = cfg["IMG_W"]

    def forward(self, data_dict, rng=None):
        rng = rng or np.random.default_rng()
        img_h, img_w = data_dict["img"].shape[:2]
        assert img_h >= self.img_h and img_w >= self.img_w
        x_start = int(rng.integers(0, img_w - self.img_w + 1))
        y_start = int(rng.integers(0, img_h - self.img_h + 1))
        _crop_all(
            data_dict, y_start, y_start + self.img_h, x_start, x_start + self.img_w
        )
        md = data_dict["metadata"]
        md["rand_y_start"], md["rand_x_start"] = y_start, x_start
        md["h_before_rand_crop"], md["w_before_rand_crop"] = img_h, img_w
        return data_dict

    def backward(self, data_dict):
        pred = data_dict["depth_pred"]
        md = data_dict["metadata"]
        out = np.zeros((md["h_before_rand_crop"], md["w_before_rand_crop"]), np.float32)
        y0, x0 = md["rand_y_start"], md["rand_x_start"]
        out[y0 : y0 + pred.shape[-2], x0 : x0 + pred.shape[-1]] = pred
        data_dict["depth_pred"] = out
        return data_dict


@PREPROCESS_REGISTRY.register()
class RandomFlip(Preprocess):
    """Sets a per-sample boolean flag only; the depth net flips its input and
    un-flips the disparity (reference augmentation.py:224-230 +
    DepthResNet.py:52-60), so the loss operates in unflipped space."""

    def forward(self, data_dict, rng=None):
        rng = rng or np.random.default_rng()
        data_dict["flip"] = bool(rng.random() > 0.5)
        return data_dict


@PREPROCESS_REGISTRY.register()
class ClipDepth(Preprocess):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.max_depth = cfg["MAX_DEPTH"]

    def forward(self, data_dict, rng=None):
        if "depth" in data_dict:
            data_dict["depth"] = np.clip(data_dict["depth"], 0, self.max_depth)
        if "ctx_depth" in data_dict:
            data_dict["ctx_depth"] = [
                np.clip(d, 0, self.max_depth) for d in data_dict["ctx_depth"]
            ]
        return data_dict


# ---------------------------------------------------------------------------
# photometric jitter
# ---------------------------------------------------------------------------


def _to_float(img: np.ndarray) -> np.ndarray:
    return np.multiply(img, np.float32(1.0 / 255.0), dtype=np.float32)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once (the product of two float32 is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """``cv2.convertScaleAbs(img, alpha=255)``: |255·x| rounded half to even, saturated."""
    return np.clip(np.rint(np.abs(img * np.float32(255.0))), 0, 255).astype(np.uint8)


_GRAY_W = np.array([0.2989, 0.587, 0.114], np.float32)
_EPS = np.float32(np.finfo(np.float32).eps)


def _gray(img: np.ndarray) -> np.ndarray:
    """``cv2.transform(img, [[0.2989, 0.587, 0.114]])`` → [H, W]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return _fma(b, _GRAY_W[2], _fma(r, _GRAY_W[0], g * _GRAY_W[1]))


def _clip01(img: np.ndarray) -> np.ndarray:
    return np.minimum(np.maximum(img, np.float32(0.0)), np.float32(1.0))


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _clip01(img * np.float32(factor))


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    f = float(factor)
    off = float((1.0 - f) * np.mean(_gray(img), dtype=np.float64))
    return _clip01(_fma(img, np.float32(f), np.float32(off)))


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    f = float(factor)
    gray = _gray(img)[..., None]
    return _clip01(_fma(img, np.float32(f), gray * np.float32(1.0 - f)))


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of float32: H in degrees, S and V in [0, 1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _EPS)
    scale = np.float32(60.0) / (diff + _EPS)
    num = np.where(v == r, g - b, np.where(v == g, b - r, r - g))
    off = np.where(v == r, np.where(g < b, np.float32(360.0), np.float32(0.0)),
                   np.where(v == g, np.float32(120.0), np.float32(240.0)))
    h = _fma(num, scale, off)
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], axis=-1)


# per sector of the hue circle: which of (v, p, q, t) is r, g, b
_SECTOR_RGB = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0], [0, 1, 2]])


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of float32 with H in degrees."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.fmod(h * np.float32(6.0 / 360.0), np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    outside = (sector < 0) | (sector >= 6)
    sector = np.where(outside, 0, sector)
    h = np.where(outside, np.float32(0.0), h)
    tab = np.stack([v, v * (np.float32(1.0) - s), v * _fma(-s, h, 1.0),
                    v * _fma(-s, np.float32(1.0) - h, 1.0)], axis=-1)
    rgb = np.take_along_axis(tab, _SECTOR_RGB[sector], axis=-1)
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.float32)


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """shift in [-0.5, 0.5] of a full hue revolution."""
    hsv = _rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0] + shift * 360.0) % 360.0
    return _clip01(_hsv_to_rgb(hsv))


@PREPROCESS_REGISTRY.register()
class RandomImageAug(Preprocess):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.jitter_prob = cfg.get("JITTER_PROB", 1.0)
        b, c, s, h = [float(v) for v in cfg.get("JITTER_PARAMS", (0.2, 0.2, 0.2, 0.05))]
        self.brightness = (max(1 - b, 0.0), 1 + b)
        self.contrast = (max(1 - c, 0.0), 1 + c)
        self.saturation = (max(1 - s, 0.0), 1 + s)
        self.hue = (-h, h)

    def forward(self, data_dict, rng=None):
        rng = rng or np.random.default_rng()
        data_dict["img_orig"] = data_dict["img"].copy()
        if "ctx_img" in data_dict:
            data_dict["ctx_img_orig"] = [a.copy() for a in data_dict["ctx_img"]]

        if rng.random() < self.jitter_prob:
            order = rng.permutation(4)
            b = float(rng.uniform(*self.brightness))
            c = float(rng.uniform(*self.contrast))
            s = float(rng.uniform(*self.saturation))
            h = float(rng.uniform(*self.hue))

            def jitter(img_u8):
                img = _to_float(img_u8)
                for fn_id in order:
                    if fn_id == 0:
                        img = adjust_brightness(img, b)
                    elif fn_id == 1:
                        img = adjust_contrast(img, c)
                    elif fn_id == 2:
                        img = adjust_saturation(img, s)
                    else:
                        img = adjust_hue(img, h)
                return _to_uint8(img)

            data_dict["img"] = jitter(data_dict["img"])
            if "ctx_img" in data_dict:
                data_dict["ctx_img"] = [jitter(a) for a in data_dict["ctx_img"]]
        return data_dict
