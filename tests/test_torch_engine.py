"""The port's training entry point: ``engine.runtime.do_train`` / ``do_test``,
the checkpoint and ``simple_main`` behind ``projects/*/train_torch.py``, on
the CPU at a small size.

(a) The slice as a whole against the JAX package's ``do_train``: MonoDepth2
    DepthResNet-18 in float32, synthetic 64x96, 8 train samples (one epoch of
    two steps at B=4), evaluation on 2 test samples with ``GT_SCALE``, both
    sides from the same weights (the port's seeded init with perturbed norm
    scales, biases and running statistics): the JAX side loads them through
    ``MODEL.WEIGHTS``, the port gets the model through ``model=``. Limits are
    those of ``tests/test_torch_train_step.py``'s trajectory: per-step losses
    rtol 2e-3, ``grad_norm`` rtol 1e-3 at the first step and 5e-3 after it,
    the trained parameters relative L2 ≤ 2e-3 and cosine ≥ 1−1e-6, the
    evaluation row rtol 2e-3 (the trained depth's limit there). Measured:
    losses 2.7e-5, ``grad_norm`` 3.1e-5 / 1.5e-3, parameters 1.3e-4,
    evaluation 4.8e-4. The second step's ``grad_norm`` is the loosest
    agreement: the synthetic frames have flat 8-pixel blocks where the warped
    and the identity candidates of the min-reprojection tie, so the gradient
    jumps with the last bits of the weights, and Adam's first update (of the
    size of the rate whatever the gradient's) carries that on (ROADMAP.md § C).
    This is the one JAX train-step compile of the port's engine tests.
(b) The port's ``do_train`` against its own step driven by hand on the batches
    ``batch_tap`` saw: equal losses.
(c) Resume: one epoch, then ``resume=True`` up to two, against two epochs in
    one run: the second epoch's losses, the parameters, the running
    statistics, the optimizer moments, ``TrainState.step`` and the noise
    generator equal (MonoDepth2, and MotionLearning with its schedule and a
    nonzero ``NOISE_STDDEV``).
(d) ``simple_main --eval`` reproduces the last in-training evaluation row; a
    weights file with a missing and an extra key loads non-strictly and logs
    both.
(e) Without ``device`` the entry points need a CUDA device (no CPU fallback).
(f) What the runtime does not do yet (several processes) raises; ``TEST.ASYNC``
    and ``VIS_PERIOD`` no longer do.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.engine.checkpoint import Checkpointer as JaxCheckpointer
from simpledepthestimation_tpu.engine.runtime import do_train as jax_do_train
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu.parallel.train_step import TrainState as JTrainState
from simpledepthestimation_tpu.solver.build import build_optimizer as jax_build_optimizer
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.engine import (
    Checkpointer, default_argument_parser, do_test, do_train, load_weights, simple_main,
)
from simpledepthestimation_tpu_torch.models import build_model, make_schedule_fn
from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables
from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

from torch_port_helpers import REPO, randomize_variables, to_numpy_tree

MONO_YAML = os.path.join(REPO, "projects", "MonoDepth2", "configs", "synthetic_quick.yaml")
MOTION_YAML = os.path.join(REPO, "projects", "MotionLearning", "configs", "synthetic_quick.yaml")
EVAL_KEYS = ("abs_rel", "sq_rel", "rms", "log_rms", "d1", "d2", "d3")


def _opts(out_dir, hw=(64, 96), train_len=8, batch=4, epochs=1, test_len=2, extra=()):
    h, w = hw
    return [
        "DATASETS.TRAIN.IMG_HEIGHT", h, "DATASETS.TRAIN.IMG_WIDTH", w, "DATASETS.TRAIN.LENGTH", train_len,
        "DATASETS.TEST.IMG_HEIGHT", h, "DATASETS.TEST.IMG_WIDTH", w, "DATASETS.TEST.LENGTH", test_len,
        "SOLVER.IMS_PER_BATCH", batch, "SOLVER.MAX_EPOCHS", epochs, "TEST.EVAL_PERIOD", 1,
        "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2, "OUTPUT_DIR", str(out_dir), *extra,
    ]


def _cfg(get, yaml, opts):
    cfg = get()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(list(opts))
    return cfg


def _eval_rows(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "kitti evaluator/abs_rel" in r]


# ---------------------------------------------------------------------------
# (a) the slice as a whole against the JAX package
# ---------------------------------------------------------------------------


def _flat_params(model):
    return np.concatenate([p.detach().numpy().astype(np.float64).ravel() for p in model.parameters()])


def test_do_train_and_eval_match_jax_do_train(tmp_path):
    opts = _opts(tmp_path / "out", extra=["TPU.MESH_SHAPE", "(1,)"])
    cfg_j = _cfg(get_cfg_jax, MONO_YAML, opts + ["OUTPUT_DIR", str(tmp_path / "jax")])
    cfg_t = _cfg(get_cfg, MONO_YAML, opts + ["OUTPUT_DIR", str(tmp_path / "port")])

    # shared weights, saved as a JAX checkpoint for the JAX side's MODEL.WEIGHTS
    model = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    params, stats = convert_meta_arch(model.state_dict(), cfg_j)
    variables = randomize_variables(to_numpy_tree({"params": params, "batch_stats": stats}))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    start = _flat_params(model)
    tx, _ = jax_build_optimizer(cfg_j, 2)
    jstate = JTrainState(step=np.zeros((), np.int32), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]))
    JaxCheckpointer(str(tmp_path / "weights")).save(0, jstate)
    cfg_j.MODEL.WEIGHTS = str(tmp_path / "weights")

    j_batches, j_metrics = [], []
    j_state = jax_do_train(cfg_j, batch_tap=j_batches.append, metrics_tap=lambda it, m: j_metrics.append((it, m)))
    t_batches, t_metrics = [], []
    state = do_train(cfg_t, model=model, device="cpu", batch_tap=t_batches.append,
                     metrics_tap=lambda it, m: t_metrics.append((it, m)))

    # the same batches reached both steps (the loaders are held key by key in test_torch_data.py)
    assert len(j_batches) == len(t_batches) == 2
    for jb, tb in zip(j_batches, t_batches):
        np.testing.assert_array_equal(tb["img"].numpy().transpose(0, 2, 3, 1), jb["img"])
        np.testing.assert_array_equal(tb["flip"].numpy(), jb["flip"])

    assert [it for it, _ in j_metrics] == [it for it, _ in t_metrics] == [0, 1]
    for i, ((_, jm), (_, tm)) in enumerate(zip(j_metrics, t_metrics)):
        assert set(tm) == set(jm) == {"total_loss", "grad_norm", "rec_loss", "smooth_loss"}
        for k in ("total_loss", "rec_loss", "smooth_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=2e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-3 if i == 0 else 5e-3)

    want = build_model(cfg_t, device="cpu")
    load_flax_variables(want, to_numpy_tree(j_state.params), to_numpy_tree(j_state.batch_stats))
    va, vb = _flat_params(state.model), _flat_params(want)
    assert np.linalg.norm(va - start) > 1e-3  # the parameters did move
    assert float(va @ vb) / float(np.linalg.norm(va) * np.linalg.norm(vb)) >= 1 - 1e-6
    assert np.linalg.norm(va - vb) / np.linalg.norm(vb) <= 2e-3

    (j_row,), (t_row,) = _eval_rows(cfg_j.OUTPUT_DIR), _eval_rows(cfg_t.OUTPUT_DIR)
    assert j_row["iteration"] == t_row["iteration"] == 2
    for k in EVAL_KEYS:
        key = f"kitti evaluator/{k}"
        np.testing.assert_allclose(t_row[key], j_row[key], rtol=2e-3, err_msg=key)
    assert os.path.isfile(os.path.join(cfg_t.OUTPUT_DIR, "model_0000.pth"))


# ---------------------------------------------------------------------------
# (b) do_train against its own step
# ---------------------------------------------------------------------------


def test_do_train_equals_its_train_step_driven_by_hand(tmp_path):
    cfg = _cfg(get_cfg, MONO_YAML, _opts(tmp_path, batch=2, train_len=4))
    batches, seen = [], []
    state = do_train(cfg, device="cpu", batch_tap=batches.append, metrics_tap=lambda it, m: seen.append(m))

    by_hand = create_train_state(cfg, device="cpu", steps_per_epoch=2)
    step = make_train_step(by_hand, grad_clip=float(cfg.SOLVER.GRAD_CLIP))
    expected = []
    for b in batches:
        m = step({k: v for k, v in b.items() if isinstance(v, torch.Tensor)})
        expected.append({k: float(v) for k, v in m.items()})
    assert len(seen) == len(expected) == 2
    assert seen == expected
    assert state.step == by_hand.step == 2
    for (k, a), b in zip(state.model.state_dict().items(), by_hand.model.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# (c) resume is exact
# ---------------------------------------------------------------------------


def _assert_same_state(a, b):
    assert a.step == b.step and a.scheduler.last_step == b.scheduler.last_step
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for name, x in sa["state"][i].items():
            assert torch.equal(x, sb["state"][i][name]), (i, name)
    assert torch.equal(a.noise_generator.get_state(), b.noise_generator.get_state())


@pytest.mark.parametrize("family", ["MonoDepth2", "MotionLearning"])
def test_resume_continues_exactly(tmp_path, family):
    yaml = MONO_YAML if family == "MonoDepth2" else MOTION_YAML
    # the rate drops after the first epoch; MotionLearning reaches its full noise and
    # motion weight within the run, so the schedule count and the generator both matter
    extra = ["SOLVER.LR_STEPS", "(1,)"]
    if family == "MotionLearning":
        extra += ["MODEL.DEPTH_NET.RAMPUP_ITERS", 2, "MODEL.POSE_NET.BURN_IN_ITERS", 4]
    schedule = (lambda cfg: make_schedule_fn(cfg)) if family == "MotionLearning" else (lambda cfg: None)

    def run(out, epochs, resume=False):
        cfg = _cfg(get_cfg, yaml, _opts(out, batch=2, train_len=4, epochs=epochs, extra=extra))
        seen = []
        state = do_train(cfg, resume=resume, schedule_fn=schedule(cfg), device="cpu",
                         metrics_tap=lambda it, m: seen.append((it, m)))
        return state, seen

    whole, whole_seen = run(tmp_path / "whole", 2)
    first, _ = run(tmp_path / "split", 1)
    assert first.step == 2
    resumed, resumed_seen = run(tmp_path / "split", 2, resume=True)

    assert [it for it, _ in resumed_seen] == [2, 3]
    assert resumed_seen == whole_seen[2:]
    _assert_same_state(resumed, whole)
    assert sorted(os.listdir(tmp_path / "split")).count("model_0001.pth") == 1
    if family == "MotionLearning":
        assert whole_seen[-1][1]["rot_loss"] != 0.0  # the motion net trained under a nonzero weight


# ---------------------------------------------------------------------------
# (d) --eval and non-strict weights
# ---------------------------------------------------------------------------


def _main(argv):
    sys.path.insert(0, os.path.join(REPO, "projects", "MonoDepth2"))
    try:
        import train_torch  # projects/MonoDepth2/train_torch.py
    finally:
        sys.path.pop(0)
    return simple_main(default_argument_parser().parse_args(argv), train_torch.train, train_torch.test)


def test_eval_reproduces_the_last_training_eval_row(tmp_path):
    argv = ["--device", "cpu", "--cfg", MONO_YAML, *map(str, _opts(tmp_path, batch=2, train_len=4, epochs=2))]
    _main(argv)
    out_dir = os.path.join(str(tmp_path), "MonoDepth2_synthetic_quick")
    rows = _eval_rows(out_dir)
    assert len(rows) == 2 and os.path.isfile(os.path.join(out_dir, "config.yaml"))
    results = _main(["--eval"] + argv)
    assert {f"kitti evaluator/{k}": v for k, v in results["kitti evaluator"].items()} == {
        k: v for k, v in rows[-1].items() if k.startswith("kitti evaluator/")}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_weights_load_non_strictly_and_log_both_sides(tmp_path):
    cfg = _cfg(get_cfg, MONO_YAML, _opts(tmp_path))
    source = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    Checkpointer(str(tmp_path / "ckpt")).save(0, source)
    sd = dict(source.model.state_dict())
    dropped = "depth_net.decoder.decoder.13.conv.weight"
    assert dropped in sd
    del sd[dropped]
    sd["depth_net.extra.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "weights.pth")

    state = create_train_state(cfg, device="cpu")
    before = state.model.state_dict()[dropped].clone()
    records = _Records()
    log = logging.getLogger("simpledepthestimation_tpu_torch.engine.checkpoint")
    log.addHandler(records)
    try:
        load_weights(str(tmp_path / "weights.pth"), state)
    finally:
        log.removeHandler(records)
    assert any(dropped in m and "not the checkpoint" in m for m in records.messages)
    assert any("depth_net.extra.weight" in m and "unused" in m for m in records.messages)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before if k == dropped else source.model.state_dict()[k]), k

    # a checkpoint directory loads its newest file, weights only
    fresh = create_train_state(cfg, device="cpu")
    load_weights(str(tmp_path / "ckpt"), fresh)
    assert all(torch.equal(v, source.model.state_dict()[k]) for k, v in fresh.model.state_dict().items())
    assert fresh.step == 0


# ---------------------------------------------------------------------------
# (e) the card unless asked otherwise, (f) what is not ported raises
# ---------------------------------------------------------------------------


def test_entry_points_need_cuda_unless_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    cfg = _cfg(get_cfg, MONO_YAML, _opts(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        do_train(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        do_test(cfg)
    for project in ("MonoDepth2", "MotionLearning"):
        res = subprocess.run(
            [sys.executable, os.path.join(REPO, "projects", project, "train_torch.py"), "--cfg", MONO_YAML,
             "OUTPUT_DIR", str(tmp_path / project)],
            cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        )
        assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr[-2000:]
        assert not os.path.exists(tmp_path / project)


@pytest.mark.parametrize("override", [("TEST.ASYNC", True), ("VIS_PERIOD", 5)], ids=["async_eval", "vis_period"])
def test_unported_runtime_options_raise(tmp_path, override, monkeypatch):
    """``TEST.ASYNC`` and ``VIS_PERIOD`` are ported (``tests/test_torch_trainer.py``):
    the runtime accepts them. What stays unported, several processes, still
    raises with either of them set."""
    from simpledepthestimation_tpu_torch.engine.runtime import check_supported
    from simpledepthestimation_tpu_torch.utils import comm

    cfg = _cfg(get_cfg, MONO_YAML, _opts(tmp_path, extra=list(override)))
    check_supported(cfg)
    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A17"):
        do_train(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A17"):
        do_test(cfg, device="cpu")


def test_several_processes_raise(tmp_path):
    args = default_argument_parser().parse_args(
        ["--device", "cpu", "--num-processes", "2", "--cfg", MONO_YAML, "OUTPUT_DIR", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A17"):
        simple_main(args, lambda cfg, **kw: None)
