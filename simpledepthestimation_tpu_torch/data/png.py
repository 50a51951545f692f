"""PNG files without OpenCV: the reader and writer the data and evaluation
code need, in numpy and the standard library's ``zlib``.

Read: non-interlaced PNG of colour type 0 (gray), 2 (RGB) or 6 (RGBA) at bit
depth 8 or 16, all five scanline filters; anything else raises. Returned as
stored, ``uint8`` or ``uint16``, channels in file order (RGB, not OpenCV's
BGR). Write: 16-bit gray, the depth-map format of KITTI and of
``evaluation.depth_evaluation.write_depth``, 8-bit gray (a mask) and 8-bit RGB
(the demo's panels).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec, section 9) → [height, width·bpp] uint8.

    A byte depends on the byte ``bpp`` to its left (sub, average, Paeth) and on
    the two above it (up, average, Paeth), so the pixels of one anti-diagonal
    (row + column = d) depend only on earlier diagonals: the loop runs over the
    height + width − 1 diagonals, each as one vector operation."""
    stride = width * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG image data has {rows.size} bytes, expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG scanline filter {ftype.max()} is not one of 0-4")
    line = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    if not (ftype == 1).any() and not (ftype >= 3).any():  # none and up only: a running sum down the columns
        up = np.where((ftype == 2)[:, None, None], line, 0)
        out = np.empty_like(line)
        acc = np.zeros((width, bpp), np.int32)
        for y in range(height):
            acc = (up[y] + acc) & 0xFF if ftype[y] == 2 else line[y]
            out[y] = acc
        return out.reshape(height, stride).astype(np.uint8)
    # skewed layout: s[y + 1, y + x + 2] holds pixel (y, x), so one diagonal is one column;
    # row 0 and column y + 1 of row y + 1 stay zero (the pixels above and left of the image)
    s = np.zeros((height + 1, height + width + 1, bpp), np.int32)
    skewed_line = np.zeros_like(s)
    ys = np.arange(height)[:, None]
    skewed_line[ys + 1, ys + np.arange(width)[None, :] + 2] = line
    m1, m2, m3, m4 = [(ftype == k).astype(np.int32)[:, None] for k in (1, 2, 3, 4)]
    for d in range(height + width - 1):
        y0, y1 = max(0, d - width + 1), min(height, d + 1)
        left = s[y0 + 1 : y1 + 1, d + 1]
        up = s[y0:y1, d + 1]
        upleft = s[y0:y1, d]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = (m1[y0:y1] * left + m2[y0:y1] * up + m3[y0:y1] * ((left + up) >> 1)
                + m4[y0:y1] * paeth)
        s[y0 + 1 : y1 + 1, d + 2] = (skewed_line[y0 + 1 : y1 + 1, d + 2] + pred) & 0xFF
    return s[ys + 1, ys + np.arange(width)[None, :] + 2].reshape(height, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """[H, W] (gray) or [H, W, C] (RGB, RGBA) array of ``uint8`` or ``uint16``."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(
            f"{path}: colour type {color}, bit depth {depth}, interlace {interlace} is not supported "
            "(non-interlaced gray, RGB or RGBA at 8 or 16 bits only)")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    return img.reshape(height, width, channels)[..., 0] if channels == 1 else img.reshape(height, width, channels)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a ``uint16`` [H, W] array as a 16-bit gray PNG, a ``uint8`` [H, W]
    array as an 8-bit gray one, or a ``uint8`` [H, W, 3] array as an 8-bit RGB
    one (zlib, filter 0 on every row)."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, color, rows = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and img.ndim == 2:
        depth, color, rows = 8, 0, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, color, rows = 8, 2, img
    else:
        raise ValueError(f"write_png takes a uint16 [H, W] or a uint8 [H, W] or [H, W, 3] array, "
                         f"not {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    rows = rows.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
