"""Recursive host/device movers and the out-of-memory retry.

The port's copy of ``simpledepthestimation_tpu/utils/memory.py``:
``to_numpy`` walks nested dicts, lists and tuples and brings every tensor to
the host as a numpy array; ``to_device`` moves every tensor or array in them to
a device (the card unless another is named); ``retry_if_oom`` runs a function
again, once, after a CUDA out-of-memory error, with the allocator's cached
blocks released in between (``torch.cuda.empty_cache``).
"""

from __future__ import annotations

import logging
from functools import wraps
from typing import Any, Optional, Union

import numpy as np
import torch

from ..models.build import resolve_device

logger = logging.getLogger(__name__)


def to_numpy(data: Any) -> Any:
    if isinstance(data, dict):
        return {k: to_numpy(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(to_numpy(v) for v in data)
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return data


def to_device(data: Any, device: Optional[Union[str, torch.device]] = None) -> Any:
    """Tensors and numpy arrays in ``data`` as tensors on ``device`` (the CUDA
    device unless another is named; it raises where there is none)."""
    device = resolve_device(device)

    def place(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(x).to(device)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x

    if isinstance(data, dict):
        return {k: to_device(v, device) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(to_device(v, device) for v in data)
    return place(data)


def retry_if_oom(func):
    """Retry once after ``torch.OutOfMemoryError`` (the original code's
    ``retry_if_cuda_oom``), with the cached blocks freed first."""

    @wraps(func)
    def wrapped(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except torch.OutOfMemoryError as e:
            logger.warning(f"OOM in {func.__name__}; retrying once: {e}")
            torch.cuda.empty_cache()
            return func(*args, **kwargs)

    return wrapped
