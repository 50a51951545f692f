"""Flax variables of the JAX package → this package's ``state_dict``.

``load_flax_variables(model, params, batch_stats)`` takes the two collections
of the JAX model as nested dicts of **numpy** arrays, in the tree layout that
``model.init`` of ``simpledepthestimation_tpu`` produces, and loads them into
the corresponding model of this package. It is the inverse of the JAX
package's ``models/torch_import.py`` (conv kernels HWIO → OIHW; norm
``scale/bias`` → ``weight/bias``; ``batch_stats`` ``mean/var`` →
``running_mean/running_var``) and is strict: a leaf that the model lacks, a
parameter the tree lacks, or a shape that differs raises ``ValueError``.

Covers the meta-architectures of this package: ``depth_net`` = DepthResNet,
GoogleResNet or GoogleResNetv2 (BatchNorm: ``bn`` + ``batch_stats``; randLN:
``rln``), PackNet01 (the inverse of ``convert_packnet``; 3D kernels DHWIO →
``[O,1,D,H,W]``) or BtsModel with any encoder of its zoo (ResNet, ResNeXt,
DenseNet, MobileNetV2; the inverse of ``convert_bts`` and of
``convert_torch_densenet`` / ``convert_torch_mobilenetv2``), optional
``pose_net`` = PoseNet, GooglePoseNet or GoogleMotionNet; the family is read
from the tree's own entries. The names produced are those that the JAX
package's ``models/torch_import.py`` converters read, so ``convert_meta_arch``
of a ``state_dict`` gives these trees back (GoogleResNetv2 has no converter
there; its names are the port's). Imports nothing of the JAX package.
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


def _bn_node(sd, key: str, params: Tree, stats: Tree, name: str) -> None:
    """A BatchNorm ``name``: affine from ``params``, statistics from ``stats``
    where it has them (a tree of gradients has none; ``load_flax_variables``
    refuses a model entry left without a value)."""
    _put_affine(sd, key, params[name])
    if name in stats:
        _put_stats(sd, key, stats[name])


def _densenet_encoder(sd, prefix: str, params: Tree, stats: Tree) -> None:
    """DenseNetEncoder: ``conv0``, ``norm0``, ``dense{i}_{j}``, ``trans{i}_norm`` /
    ``trans{i}_conv``, ``norm5`` → torchvision's ``features.conv0``,
    ``features.denseblock{i}.denselayer{j+1}.{norm1,conv1,norm2,conv2}``,
    ``features.transition{i}.{norm,conv}``, ``features.norm5``."""
    f = f"{prefix}features."
    for name, node in params.items():
        m = re.fullmatch(r"dense(\d+)_(\d+)", name)
        t = re.fullmatch(r"trans(\d+)_(norm|conv)", name)
        if m:
            key = f"{f}denseblock{m.group(1)}.denselayer{int(m.group(2)) + 1}."
            extra = set(node) - {"norm1", "conv1", "norm2", "conv2"}
            if extra:
                raise ValueError(f"unknown leaves {sorted(extra)} under {name}")
            for conv in ("conv1", "conv2"):
                _put_conv(sd, key + conv, node[conv])
            for norm in ("norm1", "norm2"):
                _bn_node(sd, key + norm, node, stats.get(name, {}), norm)
        elif t and t.group(2) == "conv":
            _put_conv(sd, f"{f}transition{t.group(1)}.conv", node)
        elif t:
            _bn_node(sd, f"{f}transition{t.group(1)}.norm", params, stats, name)
        elif name == "conv0":
            _put_conv(sd, f"{f}conv0", node)
        elif name in ("norm0", "norm5"):
            _bn_node(sd, f"{f}{name}", params, stats, name)
        else:
            raise ValueError(f"unknown DenseNet entry {name!r}")


def _mobilenet_encoder(sd, prefix: str, params: Tree, stats: Tree) -> None:
    """MobileNetV2Encoder: ``stem``/``bn_stem``, ``ir{i}`` = {[expand, bn_e,] dw,
    bn_dw, project, bn_p}, ``head``/``bn_head`` → torchvision's ``features.0.{0,1}``,
    ``features.{i}.conv.{…}``, ``features.18.{0,1}``."""
    f = f"{prefix}features."
    for name, node in params.items():
        m = re.fullmatch(r"ir(\d+)", name)
        if m:
            key = f"{f}{m.group(1)}.conv."
            expanded = "expand" in node
            order = (("expand", "bn_e", "0.0", "0.1"),) if expanded else ()
            order += (("dw", "bn_dw", f"{int(expanded)}.0", f"{int(expanded)}.1"),
                      ("project", "bn_p", f"{1 + expanded}", f"{2 + expanded}"))
            if set(node) != {n for conv, bn, _, _ in order for n in (conv, bn)}:
                raise ValueError(f"unknown leaves {sorted(node)} under {name}")
            for conv, bn, conv_key, bn_key in order:
                _put_conv(sd, key + conv_key, node[conv])
                _bn_node(sd, key + bn_key, node, stats.get(name, {}), bn)
        elif name in ("stem", "head"):
            _put_conv(sd, f"{f}{0 if name == 'stem' else 18}.0", node)
        elif name in ("bn_stem", "bn_head"):
            _bn_node(sd, f"{f}{0 if name == 'bn_stem' else 18}.1", params, stats, name)
        else:
            raise ValueError(f"unknown MobileNetV2 entry {name!r}")


def _bts_decoder(sd, prefix: str, params: Tree, stats: Tree) -> None:
    """BtsDecoder → the original BTS names (the inverse of ``convert_bts_decoder``):
    ``upconv{k}.conv``; ``conv{k}`` / ``daspp_conv`` / ``get_depth`` → ``.0``;
    ``daspp_{d}`` = {[first_bn,] conv1, bn2, conv2} →
    ``.atrous_conv.{first_bn, aconv_sequence.1/.2/.4}``; ``reduc{s}`` =
    {inter_{k}, plane_params | final} → ``.reduc.inter_{in}_{out}.0``,
    ``.reduc.plane_params``, ``.reduc.final.0`` (in and out read off the kernel)."""
    for name, node in params.items():
        if re.fullmatch(r"upconv\d", name):
            _put_conv(sd, f"{prefix}{name}.conv", node["conv"])
        elif re.fullmatch(r"bn\d(_2)?", name):
            _bn_node(sd, f"{prefix}{name}", params, stats, name)
        elif re.fullmatch(r"conv\d|daspp_conv|get_depth", name):
            _put_conv(sd, f"{prefix}{name}.0", node)
        elif re.fullmatch(r"daspp_\d+", name):
            key = f"{prefix}{name}.atrous_conv."
            if set(node) - {"first_bn", "conv1", "bn2", "conv2"}:
                raise ValueError(f"unknown leaves {sorted(node)} under {name}")
            if "first_bn" in node:
                _bn_node(sd, key + "first_bn", node, stats.get(name, {}), "first_bn")
            _put_conv(sd, key + "aconv_sequence.1", node["conv1"])
            _bn_node(sd, key + "aconv_sequence.2", node, stats.get(name, {}), "bn2")
            _put_conv(sd, key + "aconv_sequence.4", node["conv2"])
        elif re.fullmatch(r"reduc\dx\d", name):
            for sub, conv in node.items():
                if re.fullmatch(r"inter_\d+", sub):
                    _, _, cin, cout = np.shape(conv["kernel"])
                    _put_conv(sd, f"{prefix}{name}.reduc.inter_{cin}_{cout}.0", conv)
                elif sub == "plane_params":
                    _put_conv(sd, f"{prefix}{name}.reduc.plane_params", conv)
                elif sub == "final":
                    _put_conv(sd, f"{prefix}{name}.reduc.final.0", conv)
                else:
                    raise ValueError(f"unknown entry {sub!r} under {name}")
        else:
            raise ValueError(f"unknown BTS decoder entry {name!r}")


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
            _conv_gn_relu(sd, f"{prefix}{name}", node)
        else:
            raise ValueError(f"unknown pose-net entry {name!r}")


def _google_encoder(sd, prefix: str, params: Tree, stats: Tree) -> None:
    """NormResNetEncoder: ``conv1``, norm ``n1`` and blocks ``layer{L}_{b}``
    (``conv{c}``, ``n{c}``, ``down_conv``) → ``conv1``, ``bn1``,
    ``layer{L}.{b}.conv{c}`` / ``.bn{c}`` / ``.downsample.0``. A norm node is
    ``{"bn": …}`` (statistics under the same path in ``stats``) or
    ``{"rln": …}``."""

    def put_norm(tkey: str, node: Tree, stat: Optional[Tree]) -> None:
        kind = set(node)
        if kind == {"bn"}:
            _put_affine(sd, tkey, node["bn"])
            if not stat or set(stat) != {"bn"}:
                raise ValueError(f"batch_stats lack the BatchNorm statistics of {tkey}")
            _put_stats(sd, tkey, stat["bn"])
        elif kind == {"rln"}:
            _put_affine(sd, tkey, node["rln"])
        else:
            raise ValueError(f"unknown norm {sorted(kind)} at {tkey}")

    def put_unit(tprefix: str, name: str, node: Tree, stat: Tree) -> None:
        if name == "down_conv":
            _put_conv(sd, f"{tprefix}downsample.0", node)
        elif re.fullmatch(r"conv\d", name):
            _put_conv(sd, f"{tprefix}{name}", node)
        elif re.fullmatch(r"n\d", name):
            put_norm(f"{tprefix}bn{name[1:]}", node, stat.get(name))
        else:
            raise ValueError(f"unknown encoder entry {tprefix}{name}")

    for name, node in params.items():
        m = re.fullmatch(r"layer(\d+)_(\d+)", name)
        if m:
            block_stats = stats.get(name, {})
            for sub, sub_node in node.items():
                put_unit(f"{prefix}layer{m.group(1)}.{m.group(2)}.", sub, sub_node, block_stats)
        else:
            put_unit(prefix, name, node, stats)


def _google_decoder(sd, prefix: str, params: Tree) -> None:
    """GoogleDepthDecoder: ``block{i}`` = {upconv, iconv} → ``blocks.{4-i}``;
    ``out_conv``; the optional learned ``scale``."""
    for name, node in params.items():
        m = re.fullmatch(r"block(\d)", name)
        if m:
            if set(node) != {"upconv", "iconv"}:
                raise ValueError(f"unknown leaves {sorted(node)} under {prefix}{name}")
            for conv in ("upconv", "iconv"):
                _put_conv(sd, f"{prefix}blocks.{4 - int(m.group(1))}.{conv}", node[conv])
        elif name == "out_conv":
            _put_conv(sd, f"{prefix}out_conv", node)
        elif name == "scale":
            sd[f"{prefix}scale"] = np.asarray(node).reshape(1)
        else:
            raise ValueError(f"unknown decoder entry {name!r}")


def _packnet(sd, prefix: str, params: Tree) -> None:
    """PackNet01: ``pre_calc``, ``conv1``, ``iconv{i}`` = Conv2D {conv, gn} →
    ``.conv_base`` / ``.normalize``; ``conv{i}`` = {``res{b}``: {conv1, conv2,
    conv3, gn}} → ``conv{i}.{b}.…``; ``pack{i}`` / ``unpack{i}`` = {conv,
    conv3d_kernel, conv3d_bias} → ``.conv.…`` / ``.conv3d``; ``disp{i}`` =
    {conv} → ``disp{i}_layer.conv1``."""

    def conv2d(key: str, node: Tree) -> None:
        if set(node) != {"conv", "gn"}:
            raise ValueError(f"unknown leaves {sorted(node)} under {key}")
        _put_conv(sd, f"{key}.conv_base", node["conv"])
        _put_affine(sd, f"{key}.normalize", node["gn"])

    for name, node in params.items():
        key = f"{prefix}{name}"
        if name in ("pre_calc", "conv1") or re.fullmatch(r"iconv\d", name):
            conv2d(key, node)
        elif re.fullmatch(r"conv\d", name):
            for res, block in node.items():
                m = re.fullmatch(r"res(\d+)", res)
                if not m or set(block) != {"conv1", "conv2", "conv3", "gn"}:
                    raise ValueError(f"unknown entry {res!r} {sorted(block)} under {key}")
                bkey = f"{key}.{m.group(1)}"
                conv2d(f"{bkey}.conv1", block["conv1"])
                conv2d(f"{bkey}.conv2", block["conv2"])
                _put_conv(sd, f"{bkey}.conv3", block["conv3"])
                _put_affine(sd, f"{bkey}.normalize", block["gn"])
        elif re.fullmatch(r"(un)?pack\d", name):
            if set(node) != {"conv", "conv3d_kernel", "conv3d_bias"}:
                raise ValueError(f"unknown leaves {sorted(node)} under {key}")
            conv2d(f"{key}.conv", node["conv"])
            sd[f"{key}.conv3d.weight"] = np.transpose(np.asarray(node["conv3d_kernel"]), (4, 3, 0, 1, 2))
            sd[f"{key}.conv3d.bias"] = np.asarray(node["conv3d_bias"])
        elif re.fullmatch(r"disp\d", name):
            if set(node) != {"conv"}:
                raise ValueError(f"unknown leaves {sorted(node)} under {key}")
            _put_conv(sd, f"{key}_layer.conv1", node["conv"])
        else:
            raise ValueError(f"unknown PackNet entry {name!r}")


def _conv_gn_relu(sd, key: str, node: Tree) -> None:
    """ConvGNReLU {conv[, gn]} → ``{key}.0`` / ``{key}.1``."""
    extra = set(node) - {"conv", "gn"}
    if extra:
        raise ValueError(f"unknown leaves {sorted(extra)} under {key}")
    _put_conv(sd, f"{key}.0", node["conv"])
    if "gn" in node:
        _put_affine(sd, f"{key}.1", node["gn"])


def _google_posenet(sd, prefix: str, params: Tree) -> None:
    """GooglePoseNet: ``conv1..7`` (ConvGNReLU), ``pose_pred`` with bias, and the
    optional 0-d ``rot_scale`` / ``trans_scale``."""
    for name, node in params.items():
        if re.fullmatch(r"conv[1-7]", name):
            _conv_gn_relu(sd, f"{prefix}{name}", node)
        elif name == "pose_pred":
            _put_conv(sd, f"{prefix}{name}", node)
        elif name in ("trans_scale", "rot_scale"):
            sd[f"{prefix}{name}"] = np.asarray(node).reshape(())
        else:
            raise ValueError(f"unknown pose-net entry {name!r}")


def _motion_net(sd, prefix: str, params: Tree) -> None:
    """GoogleMotionNet: trunk ``conv1..7``, bias-free ``pose_pred``, seed
    ``conv8``, ``refiner{l}`` = {conv1, conv21, conv22, conv3}, and the 0-d
    learned ``trans_scale`` / ``rot_scale``."""
    for name, node in params.items():
        if re.fullmatch(r"conv[1-7]", name):
            _conv_gn_relu(sd, f"{prefix}{name}", node)
        elif name in ("pose_pred", "conv8"):
            _put_conv(sd, f"{prefix}{name}", node)
        elif re.fullmatch(r"refiner\d", name):
            extra = set(node) - {"conv1", "conv21", "conv22", "conv3"}
            if extra:
                raise ValueError(f"unknown leaves {sorted(extra)} under {prefix}{name}")
            for sub in ("conv1", "conv21", "conv22"):
                _conv_gn_relu(sd, f"{prefix}{name}.{sub}", node[sub])
            _put_conv(sd, f"{prefix}{name}.conv3", node["conv3"])
        elif name in ("trans_scale", "rot_scale"):
            sd[f"{prefix}{name}"] = np.asarray(node).reshape(())
        else:
            raise ValueError(f"unknown motion-net entry {name!r}")


def flax_to_state_dict(params: Tree, batch_stats: Optional[Tree] = None) -> Dict[str, np.ndarray]:
    """Flat ``state_dict``-style mapping (numpy arrays) from the Flax trees."""
    batch_stats = batch_stats or {}
    extra = (set(params) | set(batch_stats)) - {"depth_net", "pose_net"}
    if extra:
        raise ValueError(f"unknown top-level entries {sorted(extra)}")
    sd: Dict[str, np.ndarray] = {}
    dn_p = params.get("depth_net", {})
    dn_s = batch_stats.get("depth_net", {})
    # GoogleResNet names its norms n{c}; GoogleResNetv2 keeps its trunk in the net itself
    google = "n1" in dn_p.get("encoder", {}) or "n1" in dn_p
    if "pre_calc" in dn_p:
        if dn_s:
            raise ValueError("PackNet01 has no batch statistics")
        _packnet(sd, "depth_net.", dn_p)
        dn_p = {}
    elif "n1" in dn_p:
        _google_encoder(sd, "depth_net.", {k: v for k, v in dn_p.items() if k != "decoder"},
                        {k: v for k, v in dn_s.items() if k != "decoder"})
        dn_p = {k: v for k, v in dn_p.items() if k == "decoder"}
        dn_s = {k: v for k, v in dn_s.items() if k == "decoder"}
    extra = (set(dn_p) | set(dn_s)) - {"encoder", "decoder"}
    if extra:
        raise ValueError(f"unknown depth_net entries {sorted(extra)}")
    enc_p = dn_p.get("encoder", {})
    if "encoder" in dn_p:
        if google:
            encoder = _google_encoder
        elif "conv0" in enc_p:
            encoder = _densenet_encoder
        elif "stem" in enc_p:
            encoder = _mobilenet_encoder
        else:
            encoder = _encoder  # ResNet, ResNeXt
        encoder(sd, "depth_net.encoder.encoder.", enc_p, dn_s.get("encoder", {}))
    if "decoder" in dn_p:
        if "upconv5" in dn_p["decoder"]:
            _bts_decoder(sd, "depth_net.decoder.", dn_p["decoder"], dn_s.get("decoder", {}))
        elif google:
            _google_decoder(sd, "depth_net.decoder.", dn_p["decoder"])
        else:
            _decoder(sd, "depth_net.decoder.decoder.", dn_p["decoder"])
    if "pose_net" in params:
        if "conv8" in params["pose_net"]:
            _motion_net(sd, "pose_net.", params["pose_net"])
        elif "pose_pred" in params["pose_net"]:
            _google_posenet(sd, "pose_net.", params["pose_net"])
        else:
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
