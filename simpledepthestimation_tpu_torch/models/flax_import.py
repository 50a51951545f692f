"""Flax variables of the JAX package → this package's ``state_dict``.

``load_flax_variables(model, params, batch_stats)`` takes the two collections
of the JAX model as nested dicts of **numpy** arrays, in the tree layout that
``model.init`` of ``simpledepthestimation_tpu`` produces, and loads them into
the corresponding model of this package. It is the inverse of the JAX
package's ``models/torch_import.py`` (conv kernels HWIO → OIHW; norm
``scale/bias`` → ``weight/bias``; ``batch_stats`` ``mean/var`` →
``running_mean/running_var``) and is strict: a leaf that the model lacks, a
parameter the tree lacks, or a shape that differs raises ``ValueError``.

Covers the meta-architectures of this package (``depth_net`` = DepthResNet,
optional ``pose_net`` = PoseNet). Imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

Tree = Mapping[str, Any]


def _f2t(kernel: np.ndarray) -> np.ndarray:
    """Flax conv HWIO → torch OIHW."""
    return np.transpose(np.asarray(kernel), (3, 2, 0, 1))


def _put_conv(sd: Dict[str, np.ndarray], key: str, node: Tree) -> None:
    extra = set(node) - {"kernel", "bias"}
    if extra:
        raise ValueError(f"unknown leaves {sorted(extra)} under conv {key}")
    sd[f"{key}.weight"] = _f2t(node["kernel"])
    if "bias" in node:
        sd[f"{key}.bias"] = np.asarray(node["bias"])


def _put_affine(sd: Dict[str, np.ndarray], key: str, node: Tree) -> None:
    extra = set(node) - {"scale", "bias"}
    if extra:
        raise ValueError(f"unknown leaves {sorted(extra)} under norm {key}")
    sd[f"{key}.weight"] = np.asarray(node["scale"])
    sd[f"{key}.bias"] = np.asarray(node["bias"])


def _put_stats(sd: Dict[str, np.ndarray], key: str, node: Tree) -> None:
    extra = set(node) - {"mean", "var"}
    if extra:
        raise ValueError(f"unknown leaves {sorted(extra)} under batch_stats {key}")
    sd[f"{key}.running_mean"] = np.asarray(node["mean"])
    sd[f"{key}.running_var"] = np.asarray(node["var"])


def _torch_block_name(flax_name: str) -> str:
    """``conv1`` → ``conv1``; ``downsample_conv`` → ``downsample.0``;
    ``downsample_bn`` → ``downsample.1``."""
    return {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(
        flax_name, flax_name
    )


def _encoder(sd, prefix: str, params: Tree, stats: Tree) -> None:
    """ResNetEncoder: ``conv1``/``bn1`` and blocks ``layer{L}_{b}`` →
    torchvision names ``layer{L}.{b}``."""

    def put(tprefix: str, name: str, p_node: Tree) -> None:
        if "kernel" in p_node:
            _put_conv(sd, f"{tprefix}{_torch_block_name(name)}", p_node)
        else:
            _put_affine(sd, f"{tprefix}{_torch_block_name(name)}", p_node)

    for name, node in params.items():
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if m:
            for sub, sub_node in node.items():
                put(f"{prefix}layer{m.group(1)}.{m.group(2)}.", sub, sub_node)
        else:
            put(prefix, name, node)
    for name, node in stats.items():
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if m:
            for sub, sub_node in node.items():
                _put_stats(sd, f"{prefix}layer{m.group(1)}.{m.group(2)}.{_torch_block_name(sub)}", sub_node)
        else:
            _put_stats(sd, f"{prefix}{name}", node)


def _decoder(sd, prefix: str, params: Tree) -> None:
    """DepthDecoder: ``upconv_{i}_{j}`` → index 2·(4−i)+j (``.conv.conv``),
    ``dispconv_{s}`` → index 10+s (``.conv``)."""
    for name, node in params.items():
        m = re.fullmatch(r"upconv_(\d)_(\d)", name)
        if m:
            idx = 2 * (4 - int(m.group(1))) + int(m.group(2))
            _put_conv(sd, f"{prefix}{idx}.conv.conv", node["conv"]["conv"])
            continue
        m = re.fullmatch(r"dispconv_(\d)", name)
        if m:
            _put_conv(sd, f"{prefix}{10 + int(m.group(1))}.conv", node["conv"])
            continue
        raise ValueError(f"unknown decoder entry {name!r}")


def _posenet(sd, prefix: str, params: Tree) -> None:
    """PoseNet: ``conv{i}`` = {conv, gn} → ``conv{i}.0`` / ``conv{i}.1``;
    ``pose_head`` → ``pose_pred``."""
    for name, node in params.items():
        if name == "pose_head":
            _put_conv(sd, f"{prefix}pose_pred", node)
        elif re.fullmatch(r"conv\d", name):
            extra = set(node) - {"conv", "gn"}
            if extra:
                raise ValueError(f"unknown leaves {sorted(extra)} under {prefix}{name}")
            _put_conv(sd, f"{prefix}{name}.0", node["conv"])
            if "gn" in node:
                _put_affine(sd, f"{prefix}{name}.1", node["gn"])
        else:
            raise ValueError(f"unknown pose-net entry {name!r}")


def flax_to_state_dict(params: Tree, batch_stats: Optional[Tree] = None) -> Dict[str, np.ndarray]:
    """Flat ``state_dict``-style mapping (numpy arrays) from the Flax trees."""
    batch_stats = batch_stats or {}
    extra = (set(params) | set(batch_stats)) - {"depth_net", "pose_net"}
    if extra:
        raise ValueError(f"unknown top-level entries {sorted(extra)}")
    sd: Dict[str, np.ndarray] = {}
    dn_p = params.get("depth_net", {})
    dn_s = batch_stats.get("depth_net", {})
    extra = (set(dn_p) | set(dn_s)) - {"encoder", "decoder"}
    if extra:
        raise ValueError(f"unknown depth_net entries {sorted(extra)}")
    if "encoder" in dn_p:
        _encoder(sd, "depth_net.encoder.encoder.", dn_p["encoder"], dn_s.get("encoder", {}))
    if "decoder" in dn_p:
        _decoder(sd, "depth_net.decoder.decoder.", dn_p["decoder"])
    if "pose_net" in params:
        _posenet(sd, "pose_net.", params["pose_net"])
    if batch_stats.get("pose_net"):
        raise ValueError("pose_net has no batch statistics in this package")
    return sd


def load_flax_variables(model: nn.Module, params: Tree, batch_stats: Optional[Tree] = None) -> nn.Module:
    """Load the Flax ``params`` / ``batch_stats`` trees (numpy leaves) into
    ``model`` in place; strict on missing keys, extra keys and shapes.
    ``num_batches_tracked`` counters have no Flax counterpart and are kept."""
    sd = flax_to_state_dict(params, batch_stats)
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing:
        raise ValueError(f"Flax tree lacks {len(missing)} model entries, e.g. {missing[:5]}")
    if extra:
        raise ValueError(f"Flax tree has {len(extra)} entries the model lacks, e.g. {extra[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: tree {tuple(v.shape)} vs model {tuple(own[k].shape)}")
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(torch.from_numpy(np.array(v)).to(own[k].dtype))
    return model
