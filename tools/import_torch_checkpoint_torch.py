#!/usr/bin/env python
"""Import a checkpoint of the original PyTorch code into a checkpoint of the
PyTorch/CUDA port.

The twin of ``import_torch_checkpoint.py`` (which writes an Orbax checkpoint
of the JAX package), with the same arguments. The port's parameter names are
the original code's but for BtsModel's encoder trunk (the original's
``depth_net.encoder.base_model.*`` is the port's ``depth_net.encoder.encoder.*``,
under ``features.`` for DenseNet and MobileNetV2, whose trunk is torchvision's
``features`` itself), so the import is a ``load_state_dict`` into the model
that ``--cfg`` describes, which accepts and refuses what the JAX package's
``apply_torch_checkpoint`` does:

- the ``state_dict`` may be bare or under ``"model"`` (the original
  Checkpointer's payload); ``num_batches_tracked`` counters are dropped; the
  file is read with ``weights_only`` (a file that pickles other objects, such
  as numpy arrays, is refused, where the JAX package's tool unpickles it);
- entries that no converter of the JAX package reads (the model has no such
  tensor) are ignored and logged;
- a tensor the model has and the file lacks, or one of another shape, is
  refused with a message naming it (``ValueError``), and so are ``pose_net``
  entries for a model without a pose net;
- a depth or pose net without a converter there (``GoogleResNetv2``) is
  refused with ``NotImplementedError``.

The result is ``OUTPUT/model_{epoch:04d}.pth`` plus ``last_checkpoint``, with a
fresh optimizer (the original optimizer's state does not carry over), so
``--resume`` with ``OUTPUT_DIR`` pointing there continues at ``epoch + 1``,
and ``MODEL.WEIGHTS OUTPUT`` or ``--eval`` loads it. It runs on the CUDA card;
``--device cpu`` runs it on the CPU.

Usage:
  python tools/import_torch_checkpoint_torch.py --cfg projects/MonoDepth2/configs/resnet18.yaml \\
      --weights model_0019.pth --output output/imported [--epoch 19] [KEY VALUE ...]
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from simpledepthestimation_tpu_torch.engine import assemble_cfg  # noqa: E402
from simpledepthestimation_tpu_torch.engine.checkpoint import Checkpointer  # noqa: E402
from simpledepthestimation_tpu_torch.models.build import resolve_device  # noqa: E402
from simpledepthestimation_tpu_torch.parallel import create_train_state  # noqa: E402

logger = logging.getLogger("import_torch_checkpoint_torch")

# the nets that the JAX package's models/torch_import.py converts (_DEPTH_NET_CONVERTERS, _POSE_NET_CONVERTERS)
DEPTH_NETS = ("DepthResNet", "PackNet01", "BtsModel", "GoogleResNet")
POSE_NETS = ("PoseNet", "GooglePoseNet", "GoogleMotionNet")
# BtsModel's encoder trunk: the original code's name, the port's
BTS_TRUNK, PORT_TRUNK = "depth_net.encoder.base_model.", "depth_net.encoder.encoder."


def original_state_dict(payload):
    """The meta-architecture ``state_dict`` of a file of the original code,
    without its ``num_batches_tracked`` counters."""
    if "model" in payload and not any(k.startswith(("depth_net.", "pose_net.")) for k in payload):
        payload = payload["model"]
    return {k: v for k, v in payload.items() if not k.endswith("num_batches_tracked")}


def _port_names(sd, own):
    """``sd`` with BtsModel's trunk under the port's names (see above)."""
    trunk = PORT_TRUNK + ("features." if any(k.startswith(PORT_TRUNK + "features.") for k in own) else "")
    return {(trunk + k[len(BTS_TRUNK):] if k.startswith(BTS_TRUNK) else k): v for k, v in sd.items()}


def apply_original_state_dict(model: torch.nn.Module, sd, cfg) -> list:
    """Load ``sd`` (see :func:`original_state_dict`) into ``model`` in place;
    returns the names it ignored."""
    depth_name = str(cfg.MODEL.DEPTH_NET.NAME)
    if depth_name not in DEPTH_NETS:
        raise NotImplementedError(f"no importer for depth net {depth_name}: the JAX package converts "
                                  f"{', '.join(DEPTH_NETS)} only")
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    sd = _port_names(sd, own)
    if any(k.startswith("pose_net.") for k in sd):
        pose_name = str(cfg.MODEL.POSE_NET.NAME)
        if pose_name not in POSE_NETS:
            raise NotImplementedError(f"no importer for pose net {pose_name}: the JAX package converts "
                                      f"{', '.join(POSE_NETS)} only")
        if not any(k.startswith("pose_net.") for k in own):
            raise ValueError(f"the checkpoint holds pose_net entries and the {type(model).__name__} of this "
                             "config has no pose net")
    missing = [k for k in own if k not in sd]
    if missing:
        raise ValueError(f"the checkpoint lacks {len(missing)} of the model's tensors, e.g. {missing[:5]}")
    for k, v in own.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(sd[k].shape)} vs model {tuple(v.shape)}")
    ignored = sorted(k for k in sd if k not in own)
    if ignored:
        logger.warning(f"Ignored {len(ignored)} checkpoint entries the model has no tensor for: {ignored[:20]}"
                       + (" ..." if len(ignored) > 20 else ""))
    with torch.no_grad():
        for k, v in own.items():
            v.copy_(torch.as_tensor(sd[k]).to(v.dtype))
    return ignored


def main(argv=None):
    """Write the port's checkpoint; returns its path."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", required=True, help="checkpoint of the original code (.pth)")
    p.add_argument("--output", required=True, help="output checkpoint directory")
    p.add_argument("--epoch", type=int, default=0, help="epoch number to record (for --resume continuation)")
    p.add_argument("--device", default="cuda", help="torch device to build the model on (default: the CUDA card)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = assemble_cfg(args)

    # weights only: a file from elsewhere is not unpickled in full (the JAX package's
    # tool does that); the original Checkpointer's payload of tensors, numbers and
    # state dicts loads this way
    payload = torch.load(args.weights, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model" in payload and hasattr(payload["model"], "items"):
        payload = payload["model"]
    state = create_train_state(cfg, device=device, warm_start=False)
    apply_original_state_dict(state.model, original_state_dict(payload), cfg)
    path = Checkpointer(args.output).save(args.epoch, state)
    print(f"imported {args.weights} -> {path} (epoch {args.epoch})")
    return path


if __name__ == "__main__":
    main()
