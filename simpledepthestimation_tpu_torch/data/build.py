"""Dataset base class, NCHW batch collation and the loader builders.

The port's copy of ``simpledepthestimation_tpu/data/build.py``. A sample stays
a dict of HWC numpy arrays through the preprocess list; the collator stacks a
batch into float32 ``torch`` tensors in the port's layout: ``img`` and
``img_orig`` ``[B,3,H,W]``, ``ctx_img`` and ``ctx_img_orig`` ``[B,N,3,H,W]``,
``depth`` and ``mask`` ``[B,1,H,W]``, ``ctx_depth`` and ``ctx_mask``
``[B,N,1,H,W]``, ``intrinsics`` ``[B,3,3]``, ``pose_gt`` ``[B,4,4]`` and a bool
``flip`` ``[B]`` (per sample; with ``PARITY.STRICT`` sample 0's flag for the
whole batch, as the reference collator does). Every other key (``metadata``,
``depth_orig``) stays a list of the samples' values.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import comm
from ..utils.registry import Registry
from .loader import PrefetchLoader
from .preprocess import build_preprocess
from .samplers import EpochSampler, InferenceSampler, TrainingSampler

logger = logging.getLogger(__name__)

DATASET_REGISTRY = Registry("DATASET")

# key → (per-sample layout, batch layout): "hwc" frames become CHW, "hw" maps
# gain a channel axis; a list-valued key (contexts) gains the N axis after B
_LAYOUT = {
    "img": "hwc", "img_orig": "hwc", "ctx_img": "hwc", "ctx_img_orig": "hwc",
    "depth": "hw", "mask": "hw", "ctx_depth": "hw", "ctx_mask": "hw",
    "intrinsics": "mat", "pose_gt": "mat",
}


def _stack(vals: List[np.ndarray], layout: str, pin_memory: bool) -> torch.Tensor:
    """Stack per-sample numpy arrays (or lists of them) into one float32
    tensor, written once into its final (optionally page-locked) buffer."""
    first = vals[0]
    nested = isinstance(first, (list, tuple))
    one = np.asarray(first[0] if nested else first)
    if layout == "hwc":
        item = (one.shape[2], one.shape[0], one.shape[1])
    elif layout == "hw":
        item = (1,) + one.shape
    else:
        item = one.shape
    lead = (len(vals), len(first)) if nested else (len(vals),)
    out = torch.empty(lead + item, dtype=torch.float32, pin_memory=pin_memory)
    for i, v in enumerate(vals):
        for j, a in enumerate(v if nested else [v]):
            t = torch.from_numpy(np.asarray(a, dtype=np.float32))
            if layout == "hwc":
                t = t.permute(2, 0, 1)
            dst = out[i, j] if nested else out[i]
            dst.copy_(t.reshape(dst.shape))
    return out


class DatasetBase:
    """Map-style dataset: index → preprocessed sample dict.

    Holds the preprocess pipeline built from the yaml ``PREPROCESS`` list;
    ``get_prediction`` runs it backward to bring a prediction to the original
    image frame."""

    def __init__(self, dataset_cfg, cfg):
        self.preprocesses = [build_preprocess(p) for p in dataset_cfg.get("PREPROCESS", [])]
        self.strict_parity = bool(cfg.get("PARITY", {}).get("STRICT", False))

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        raise NotImplementedError

    def get_sample(self, idx: int, rng: Optional[np.random.Generator] = None):
        """Like ``__getitem__``, with an explicit generator for the random ops."""
        raise NotImplementedError

    def preprocess(self, data_dict, rng: Optional[np.random.Generator] = None):
        for op in self.preprocesses:
            data_dict = op.forward(data_dict, rng)
        return data_dict

    def get_prediction(self, data_dict):
        for op in self.preprocesses[::-1]:
            data_dict = op.backward(data_dict)
        return data_dict

    def batch_collator(self, batch_list: List[Dict[str, Any]], pin_memory: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in batch_list[0].keys():
            vals = [d[key] for d in batch_list]
            if key in _LAYOUT:
                out[key] = _stack(vals, _LAYOUT[key], pin_memory)
            elif key == "flip":
                flags = [bool(vals[0])] * len(vals) if self.strict_parity else [bool(v) for v in vals]
                out[key] = torch.tensor(flags, dtype=torch.bool)
                if pin_memory:
                    out[key] = out[key].pin_memory()
            else:
                out[key] = vals  # metadata and friends stay host-side lists
        return out


def build_train_loader(cfg, seed: int = 0, pin_memory: bool = False) -> PrefetchLoader:
    """Epoch-based train loader for this process: ``IMS_PER_BATCH`` divided by
    the world size."""
    dataset = DATASET_REGISTRY.get(cfg.DATASETS.TRAIN.NAME)(cfg.DATASETS.TRAIN, cfg)
    assert isinstance(dataset, DatasetBase)

    total_batch = int(cfg.SOLVER.IMS_PER_BATCH)
    world = comm.get_world_size()
    if total_batch % world:
        raise ValueError(f"IMS_PER_BATCH={total_batch} must be divisible by world size {world}")

    sampler_name = cfg.DATALOADER.SAMPLER_TRAIN
    logger.info(f"Using training sampler {sampler_name}")
    if sampler_name == "DDPSampler":
        sampler = EpochSampler(len(dataset), shuffle=True, seed=seed, rank=comm.get_rank(), world_size=world)
    elif sampler_name == "TrainingSampler":
        sampler = TrainingSampler(len(dataset), shuffle=True, seed=seed, rank=comm.get_rank(), world_size=world)
    else:
        raise ValueError(f"Unknown training sampler: {sampler_name}")

    return PrefetchLoader(
        dataset, sampler, batch_size=total_batch // world, drop_last=True,
        num_workers=int(cfg.DATALOADER.NUM_WORKERS), prefetch=int(cfg.DATALOADER.get("PREFETCH", 2)),
        seed=seed, pin_memory=pin_memory,
    )


def build_test_loader(cfg) -> Optional[PrefetchLoader]:
    """Inference loader (``TEST.IMS_PER_BATCH``, 1 by default), sharded so that
    every sample is seen once; ``None`` without a test dataset."""
    if "TEST" not in cfg.DATASETS or not cfg.DATASETS.TEST.get("NAME"):
        return None
    dataset = DATASET_REGISTRY.get(cfg.DATASETS.TEST.NAME)(cfg.DATASETS.TEST, cfg)
    assert isinstance(dataset, DatasetBase)
    sampler = InferenceSampler(len(dataset), rank=comm.get_rank(), world_size=comm.get_world_size())
    return PrefetchLoader(
        dataset, sampler, batch_size=int(cfg.TEST.get("IMS_PER_BATCH", 1)), drop_last=False,
        num_workers=int(cfg.DATALOADER.NUM_WORKERS), prefetch=int(cfg.DATALOADER.get("PREFETCH", 2)),
        seed=0,
    )
