"""The port's ``DefaultPredictor`` and its serving export (``engine/export.py``)
against the JAX package, on the CPU.

``SupDepthModel`` with DepthResNet-18 in float32 (Supervised
``synthetic_quick.yaml``), the test preprocess a ``Resize`` to 64x128 and
``ToTensor``, the same weights on both sides (the port's seeded init,
perturbed, carried to the JAX tree by ``convert_meta_arch``; the JAX side's
``create_train_state`` is handed that tree, whose eager Flax ``init`` would
take 40 s on the CPU). Measured on an 8-core Intel Xeon CPU, limits beside:

- ``DefaultPredictor`` on a random 128x200 uint8 frame: depth of the frame's
  shape, the JAX package's within 5e-6 of its largest value (measured 7.7e-7;
  the nearest-neighbour resize back is the same map on both sides, so the
  error is the network's);
- ``export_inference`` → ``load_exported``: the program equals eager to the bit
  (float32 and bfloat16 convolutions), and the JAX model's ``apply``
  (``train=False``, what the JAX package's exported ``infer`` runs) within
  5e-6 (measured 1.4e-6); the sidecar states NCHW in and out;
- without a checkpoint the export is refused (``FileNotFoundError``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpledepthestimation_tpu.config import CfgNode as JCfgNode
from simpledepthestimation_tpu.engine import runtime as jax_runtime
from simpledepthestimation_tpu.engine.trainer import DefaultPredictor as JaxDefaultPredictor
from simpledepthestimation_tpu.parallel.train_step import TrainState as JTrainState
from simpledepthestimation_tpu_torch.config import CfgNode
from simpledepthestimation_tpu_torch.engine import DefaultPredictor, export_inference, load_exported
from simpledepthestimation_tpu_torch.engine.export import InferenceModule
from simpledepthestimation_tpu_torch.engine.runtime import restore_inference_state
from simpledepthestimation_tpu_torch.models import build_model

from torch_port_helpers import nhwc, shared_variables, supervised_cfgs

H, W = 64, 128
DEPTH_RTOL = 5e-6


def _test_preprocess(cfg, node):
    cfg.DATASETS.TEST.PREPROCESS = [node({"NAME": "Resize", "IMG_W": W, "IMG_H": H}), node({"NAME": "ToTensor"})]


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    root = tmp_path_factory.mktemp("predictor")
    opts = ["TPU.COMPUTE_DTYPE", "float32", "TPU.MESH_SHAPE", "(1,)",
            "DATASETS.TEST.IMG_HEIGHT", H, "DATASETS.TEST.IMG_WIDTH", W]
    cfg_j, cfg_t = supervised_cfgs("synthetic_quick.yaml", opts)
    _test_preprocess(cfg_j, JCfgNode)
    _test_preprocess(cfg_t, CfgNode)
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    variables = shared_variables(port, cfg_j)
    torch.save(port.state_dict(), root / "weights.pth")
    cfg_t.MODEL.WEIGHTS, cfg_t.OUTPUT_DIR = str(root / "weights.pth"), str(root / "port")
    cfg_j.OUTPUT_DIR = str(root / "jax")

    def shared_state(model, optimizer, sample_batch, rng, train=True):
        return JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=optimizer.init(variables["params"]))

    frame = np.random.RandomState(0).randint(0, 255, (128, 200, 3), np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runtime, "create_train_state", shared_state)
        jax_predictor = JaxDefaultPredictor(cfg_j)
        want = jax_predictor(frame)
    yield dict(root=root, cfg_t=cfg_t, frame=frame, want=want, jax_predictor=jax_predictor)
    shutil.rmtree(root, ignore_errors=True)  # the weights and two exported programs


def test_default_predictor_matches_the_jax_predictor(shared):
    predictor = DefaultPredictor(shared["cfg_t"], device="cpu")
    depth = predictor(shared["frame"])
    want = shared["want"]
    assert depth.shape == want.shape == (128, 200) and depth.dtype == np.float32
    assert np.isfinite(depth).all() and (depth > 0).all()
    assert np.abs(depth - want).max() / np.abs(want).max() <= DEPTH_RTOL
    np.testing.assert_array_equal(predictor(shared["frame"]), depth)  # the state is loaded once


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_equals_eager_and_the_jax_apply(shared, dtype):
    cfg = shared["cfg_t"].clone()
    cfg.TPU.COMPUTE_DTYPE = dtype
    path = export_inference(cfg, str(shared["root"] / f"model_{dtype}.pt2"), device="cpu")
    meta = json.load(open(path + ".json"))
    assert meta["input"] == {"shape": [1, 3, H, W], "dtype": "float32", "layout": "NCHW"}
    assert meta["output"] == "depth [B,1,H,W] (meters)" and meta["platforms"] == ["cpu"]
    assert meta["meta_architecture"] == "SupDepthModel"

    img = torch.from_numpy(np.random.RandomState(1).rand(1, 3, H, W).astype(np.float32))
    served = load_exported(path)(img)
    state, had_checkpoint = restore_inference_state(cfg, device="cpu")
    assert had_checkpoint
    with torch.no_grad():
        eager = InferenceModule(state.model)(img)
    assert served.shape == (1, 1, H, W) and served.dtype == torch.float32
    assert torch.equal(served, eager)
    if dtype == "float32":
        jp = shared["jax_predictor"]
        want = np.asarray(jp._eval_step(jp.state, {"img": nhwc(img)}))  # the JAX package's infer
        got = nhwc(served)
        assert np.abs(got - want).max() / np.abs(want).max() <= DEPTH_RTOL


def test_export_refuses_random_weights(shared, tmp_path):
    cfg = shared["cfg_t"].clone()
    cfg.MODEL.WEIGHTS, cfg.OUTPUT_DIR = "", str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="random-init"):
        export_inference(cfg, str(tmp_path / "model.pt2"), device="cpu")
    assert not os.path.exists(tmp_path / "model.pt2")
