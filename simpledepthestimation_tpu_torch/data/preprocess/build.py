"""Preprocess framework: a registry of invertible sample transforms.

The port's copy of ``simpledepthestimation_tpu/data/preprocess/build.py``.
Each op has ``forward(data_dict, rng)`` (numpy on the host, in the loader's
threads) and ``backward(data_dict)`` (the inverse, applied to predictions at
evaluation). Random ops draw from the ``np.random.Generator`` they are given,
so a sample is reproducible from (seed, epoch, index).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ...utils.registry import Registry

PREPROCESS_REGISTRY = Registry("PREPROCESS")


class Preprocess:
    def __init__(self, cfg):
        self.cfg = cfg

    def forward(self, data_dict: Dict[str, Any], rng: Optional[np.random.Generator] = None):
        return data_dict

    def backward(self, data_dict: Dict[str, Any]):
        return data_dict


def build_preprocess(cfg) -> Preprocess:
    op = PREPROCESS_REGISTRY.get(cfg["NAME"])(cfg)
    assert isinstance(op, Preprocess)
    return op
