"""Builds and loads the hand-written CUDA kernels under ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library is built at first use, from the sources in
the checkout, into ``<checkout>/build/kernels``; its file name carries a hash of the sources, so an edited source is rebuilt.
One ``nvcc -c`` per source runs in parallel, then one link step.

Nothing here runs at import time: the CPU-only tests import every module.
A failed build raises; no caller falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import List, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of simpledepthestimation_tpu_torch cannot be built"
    )


def _source_hash(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _build(lib_path: str, srcs: List[str], verbose: bool) -> None:
    nvcc = _find_nvcc()
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs, objs = [], []
    for src in srcs:
        obj = os.path.join(out_dir, os.path.basename(src) + f".{os.getpid()}.o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = None
    for cmd, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0 and failed is None:
            failed = (cmd, out)
    if failed is not None:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{failed[1]}")
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed: {' '.join(link)}\n{res.stdout}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    if verbose:
        print("".join(logs), file=sys.stderr, flush=True)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # every entry point ends in (device, stream): the CUDA device to launch on and its stream
    # int sde_warp_bilinear_fwd(img, x, y, out, B, C, Hi, Wi, Ho, Wo, is_bf16, device, stream)
    lib.sde_warp_bilinear_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.sde_warp_bilinear_fwd.restype = i
    # int sde_photometric_map_fwd(a, b, out, B, C, H, W, alpha, C1, C2, is_bf16, device, stream)
    lib.sde_photometric_map_fwd.argtypes = [p, p, p, i, i, i, i, f, f, f, i, i, p]
    lib.sde_photometric_map_fwd.restype = i
    # int sde_warp_bilinear_bwd_coords(img, x, y, ct, dx, dy, B, C, Hi, Wi, Ho, Wo, is_bf16, device, stream)
    lib.sde_warp_bilinear_bwd_coords.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.sde_warp_bilinear_bwd_coords.restype = i
    # int sde_photometric_map_bwd(a, b, g, g_a, g_b, B, C, H, W, alpha, C1, C2, is_bf16, device, stream)
    lib.sde_photometric_map_bwd.argtypes = [p, p, p, p, p, i, i, i, i, f, f, f, i, i, p]
    lib.sde_photometric_map_bwd.restype = i
    # int sde_warp_bilinear_bwd_image(ct, x, y, d_img, B, C, Hi, Wi, Ho, Wo, is_bf16, device, stream)
    lib.sde_warp_bilinear_bwd_image.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.sde_warp_bilinear_bwd_image.restype = i
    lib.sde_error_string.argtypes = [i]
    lib.sde_error_string.restype = ctypes.c_char_p


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' library, built first if this checkout has not built it yet.
    Once loaded it is returned without taking the lock."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
        lib_path = os.path.join(build_dir(), f"libsde_kernels_{_source_hash(srcs)}.so")
        if not os.path.isfile(lib_path):
            _build(lib_path, srcs, verbose)
        lib = ctypes.CDLL(lib_path)
        _declare(lib)
        _lib = lib
        return lib


def stream_handle(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device
    ``device_index``, as an int (without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.sde_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
