"""The Supervised family with DepthResNet: the port vs the JAX package on the CPU,
and ``projects/Supervised/train_torch.py``.

``projects/Supervised/configs/resnet18.yaml`` (SupDepthModel, DepthResNet
``18pt`` with ``UPSAMPLE_DEPTH``; nothing loads ImageNet weights here) in
float32 at B=2, 64x128, on batches whose ground truth has a third of its pixels
≤ 1 (outside ``silog_loss``'s mask) and whose second sample is flipped.
Weights: the port's seeded init, carried to the JAX tree by the JAX package's
``convert_meta_arch``, perturbed with numpy, loaded back with ``load_flax_variables``.
(At 64x96 one tensor of the JAX gradient, ``layer3.0.conv1``, lay 8 % off both
the port's float32 gradient and the port run in float64, which agree to 7.5e-6
there: a kink that XLA's rounding crosses on that batch. 64x128, the shape of
the MonoDepth2 tests, has none.)

Measured on an 8-core Intel Xeon CPU, limits beside:
- the parameter gradient against ``jax.grad``: per tensor ``max|Δ| / max|g|``
  1.5e-5 at most (1e-4);
- three ``adamw_poly`` steps at ``Base.yaml``'s recipe (``DEPTH_LR`` 1e-4,
  ``DEPTH_END_LR`` 1e-5, ``WEIGHT_DECAY`` 0.01 on the encoder group only,
  eps 1e-6), ``MAX_EPOCHS`` 2 of 2 steps so that the poly rate decays at each
  step, against the JAX package's own train step: the rate (1e-6 relative),
  the loss 6.8e-7 (1e-5), ``grad_norm`` 7.8e-6 (1e-4, tighter than the 5e-3
  after Adam steps of ``ROADMAP.md`` § C, because it holds), and after each
  step the parameters 1.0e-6 in relative L2 (1e-5) and their change 7.9e-4 of
  its size (5e-3).
- ``projects/Supervised/train_torch.py --device cpu`` at a tiny size: two epochs
  with a checkpoint and an evaluation each, then ``--eval`` gives the last
  evaluation row exactly. The port alone: ``tests/test_torch_engine.py`` holds
  the engine against the JAX package's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu.parallel.mesh import build_mesh
from simpledepthestimation_tpu.parallel.train_step import TrainState as JTrainState
from simpledepthestimation_tpu.parallel.train_step import make_train_step as jax_make_train_step
from simpledepthestimation_tpu.solver.build import build_optimizer as jax_build_optimizer
from simpledepthestimation_tpu_torch.engine import default_argument_parser, simple_main
from simpledepthestimation_tpu_torch.engine import defaults as engine_defaults
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict, load_flax_variables
from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

from torch_port_helpers import REPO, batch_to_torch, make_sup_batch, shared_variables, supervised_cfgs

B, H, W = 2, 64, 128
RECIPE = ["TPU.COMPUTE_DTYPE", "float32", "SOLVER.MAX_EPOCHS", "2"]
STEPS_PER_EPOCH, N_STEPS = 2, 3
GRAD_RTOL = 1e-4
LOSS_RTOL, NORM_RTOL, PARAM_REL_L2, UPDATE_REL = 1e-5, 1e-4, 1e-5, 5e-3  # measured: module docstring


@pytest.fixture(scope="module")
def shared():
    cfg_j, cfg_t = supervised_cfgs("resnet18.yaml", RECIPE)
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    variables = shared_variables(port, cfg_j)
    batches = [make_sup_batch(seed=20 + i, B=B, H=H, W=W, flip=(False, True)) for i in range(N_STEPS)]
    return cfg_j, cfg_t, variables, batches


def test_config_is_the_shipped_recipe(shared):
    _, cfg_t, _, _ = shared
    dn, solver = cfg_t.MODEL.DEPTH_NET, cfg_t.SOLVER
    assert (str(dn.NAME), str(dn.ENCODER_NAME), bool(dn.UPSAMPLE_DEPTH)) == ("DepthResNet", "18pt", True)
    assert (str(solver.OPT), solver.DEPTH_LR, solver.DEPTH_END_LR, solver.WEIGHT_DECAY) == (
        "adamw_poly", 1e-4, 1e-5, 0.01)


def test_parameter_gradient_matches_jax_grad(shared):
    cfg_j, cfg_t, variables, batches = shared
    model_j = build_model_jax(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(params):
        out, _ = model_j.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb, train=True,
                               mutable=["batch_stats"])
        return out["silog_loss"]

    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"])))
    port = build_model(cfg_t, device="cpu")
    load_flax_variables(port, variables["params"], variables["batch_stats"])
    out = port(batch_to_torch(batches[0]), train=True)
    assert set(out) == {"silog_loss"}
    out["silog_loss"].backward()
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(grads) == set(ref)
    errs = {k: np.abs(g - ref[k]).max() / np.abs(ref[k]).max() for k, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert all(np.abs(g).max() > 0 for g in grads.values())


def _flat(sd, keys):
    return np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in keys])


def test_three_adamw_poly_steps_match_the_jax_step(shared):
    cfg_j, cfg_t, variables, batches = shared
    tx, schedule = jax_build_optimizer(cfg_j, STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    j_state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                          opt_state=tx.init(params))
    j_step = jax_make_train_step(build_model_jax(cfg_j), tx, build_mesh(shape=(1,)), donate=False, adaptive_ywin=0)

    state = create_train_state(cfg_t, device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    load_flax_variables(state.model, variables["params"], variables["batch_stats"])
    assert [(g["name"], g["weight_decay"], g["eps"]) for g in state.optimizer.param_groups] == [
        ("encoder", 0.01, 1e-6), ("decoder", 0.0, 1e-6)]
    step = make_train_step(state)
    keys = [k for k, _ in state.model.named_parameters()]
    prev = _flat({k: p.detach() for k, p in state.model.named_parameters()}, keys)
    rates = []
    for i, batch in enumerate(batches):
        rates.append(state.scheduler.get_last_lr())
        assert rates[-1] == pytest.approx([float(schedule(i))] * 2, rel=1e-6)
        metrics = {k: float(v) for k, v in step(batch_to_torch(batch)).items()}
        j_state, jm = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
        jm = {k: float(v) for k, v in jm.items()}
        assert set(metrics) == set(jm) == {"total_loss", "grad_norm", "silog_loss"}
        want = _flat(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, j_state.params)), keys)
        have = _flat({k: p.detach() for k, p in state.model.named_parameters()}, keys)
        assert metrics["silog_loss"] == pytest.approx(jm["silog_loss"], rel=LOSS_RTOL), i
        assert metrics["grad_norm"] == pytest.approx(jm["grad_norm"], rel=NORM_RTOL), i
        assert np.linalg.norm(have - want) <= PARAM_REL_L2 * np.linalg.norm(want), i
        assert np.linalg.norm((have - prev) - (want - prev)) <= UPDATE_REL * np.linalg.norm(want - prev), i
        prev = have
    assert state.step == N_STEPS == int(j_state.step)
    assert rates[0][0] > rates[1][0] > rates[2][0]  # the poly rate decays at every step


def _entry():
    """``projects/Supervised/train_torch.py`` as a module of its own name (the
    MonoDepth2 and MotionLearning twins share the file name)."""
    path = os.path.join(REPO, "projects", "Supervised", "train_torch.py")
    spec = importlib.util.spec_from_file_location("train_torch_supervised", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_torch_trains_checkpoints_and_eval_reproduces(tmp_path, monkeypatch):
    """Two epochs on the synthetic dataset, ``--eval`` after; and the card by default."""
    # no tensorboard writer: its import costs seconds and nothing here reads it
    monkeypatch.setattr(engine_defaults, "tensorboard_writer_or_none", lambda *a, **k: None)
    entry = _entry()
    argv = ["--cfg", os.path.join(REPO, "projects", "Supervised", "configs", "synthetic_quick.yaml"),
            "TPU.COMPUTE_DTYPE", "float32", "DATASETS.TRAIN.LENGTH", "8", "DATASETS.TEST.LENGTH", "2",
            "DATASETS.TRAIN.IMG_HEIGHT", "64", "DATASETS.TRAIN.IMG_WIDTH", "96",
            "DATASETS.TEST.IMG_HEIGHT", "64", "DATASETS.TEST.IMG_WIDTH", "96", "SOLVER.IMS_PER_BATCH", "4",
            "SOLVER.MAX_EPOCHS", "2", "TEST.EVAL_PERIOD", "1", "DATALOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1",
            "OUTPUT_DIR", str(tmp_path)]

    def main(extra):
        return simple_main(default_argument_parser().parse_args(extra + argv), entry.train, entry.test)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    state = main(["--device", "cpu"])
    assert state.step == 4 and next(state.model.parameters()).device.type == "cpu"
    run_dir = tmp_path / "Supervised_synthetic_quick"
    assert sorted(f for f in os.listdir(run_dir) if f.startswith("model_")) == ["model_0000.pth", "model_0001.pth"]
    with open(run_dir / "metrics.json") as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "silog_loss" in r]
    evals = [r for r in rows if "kitti evaluator/abs_rel" in r]
    assert [r["iteration"] for r in steps] == [0, 1, 2, 3] and all(np.isfinite(r["silog_loss"]) for r in steps)
    assert len(evals) == 2 and all(np.isfinite(v) for v in evals[-1].values())
    results = main(["--device", "cpu", "--eval"])
    assert {f"kitti evaluator/{k}": v for k, v in results["kitti evaluator"].items()} == {
        k: v for k, v in evals[-1].items() if k.startswith("kitti evaluator/")}
