"""Path manager: scheme-dispatched file access.

The port's copy of ``simpledepthestimation_tpu/utils/file_io.py``: local
paths pass through; a scheme can register a resolver (the ``sde-tpu://``
model-zoo prefix maps to a local asset directory). No network handlers.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict

_HANDLERS: Dict[str, Callable[[str], str]] = {}


def register_scheme(prefix: str, resolver: Callable[[str], str]) -> None:
    """``resolver`` maps the full path (with prefix) to a local filesystem path."""
    _HANDLERS[prefix] = resolver


def get_local_path(path: str) -> str:
    for prefix, resolver in _HANDLERS.items():
        if path.startswith(prefix):
            return resolver(path)
    return path


def open_file(path: str, mode: str = "r"):
    return open(get_local_path(path), mode)


def exists(path: str) -> bool:
    return os.path.exists(get_local_path(path))


def mkdirs(path: str) -> None:
    os.makedirs(get_local_path(path), exist_ok=True)


def copy(src: str, dst: str) -> None:
    shutil.copy(get_local_path(src), get_local_path(dst))


def _zoo_resolver(path: str) -> str:
    root = os.environ.get("SDE_TPU_MODEL_ZOO", os.path.expanduser("~/.cache/sde_tpu_zoo"))
    return os.path.join(root, path[len("sde-tpu://"):])


register_scheme("sde-tpu://", _zoo_resolver)
