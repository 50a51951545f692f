"""JPEG frames without OpenCV: ``read_jpeg`` gives the pixels that
``cv2.imread(path)`` followed by BGR→RGB gives, through Pillow.

Pillow's default decode (libjpeg's ISLOW inverse DCT and fancy chroma
upsampling, no ``draft`` scaling) is the one OpenCV's ``imread`` runs, and
gives the same bytes on baseline and progressive files at every chroma
subsampling (tests/test_torch_jpeg.py). What ``imread`` adds is done here:

- the EXIF orientation is applied (``ImageOps.exif_transpose``);
- a gray file is repeated to three channels.

A file in any mode other than gray (``L``) or ``RGB`` (CMYK and YCCK among
them, whose conversion to RGB differs between Pillow and OpenCV) raises
``ValueError`` naming the mode. Pillow is imported in the function, so that
importing the package or reading a PNG never loads it; where it does not
import, reading a JPEG file raises and nothing else decodes it.
"""

from __future__ import annotations

import os

import numpy as np

SIGNATURE = b"\xff\xd8\xff"


def read_jpeg(path: str) -> np.ndarray:
    """[H, W, 3] ``uint8`` RGB array of the JPEG file at ``path``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} does not exist!")
    with open(path, "rb") as f:
        if f.read(len(SIGNATURE)) != SIGNATURE:
            raise ValueError(f"{path} is not a JPEG file")
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(f"reading the JPEG file {path} needs Pillow (PIL), which does not import here ({e})") from e
    with Image.open(path) as img:
        img = ImageOps.exif_transpose(img)
        if img.mode not in ("L", "RGB"):
            raise ValueError(f"{path}: a JPEG file in mode {img.mode} is not supported (gray or RGB only)")
        out = np.array(img, dtype=np.uint8)
    if out.ndim == 2:
        return np.repeat(out[..., None], 3, axis=2)
    return out
