"""The three ``resnet18_waymo.yaml`` (each extends its project's
``Base_waymo.yaml``, which names no model) through the port's entry points,
``projects/{MonoDepth2,MotionLearning,Supervised}/train_torch.py --device cpu``,
on a fabricated tree of 1280x1920 JPEG frames: one epoch of one step at B=2
(float32; the shipped B=16 bf16 runs on the card, ``chip_smoke.py``), an
evaluation with the four KITTI evaluators on two test frames (MonoDepth2 at
192x480, MotionLearning at 128x416, Supervised at 768x1920 with no resize),
then ``--eval``, which must give the last evaluation row exactly. Checked: a
finite loss, the checkpoint, the evaluation rows. Also ``tools/train_net_torch.py``
on MonoDepth2's, and the card by default: without ``--device cpu`` each entry
point raises where there is none.
"""

import importlib.util
import json
import math
import os
import shutil

import pytest
import torch

from simpledepthestimation_tpu_torch.engine import default_argument_parser, simple_main
from simpledepthestimation_tpu_torch.engine import defaults as engine_defaults

from torch_port_helpers import REPO, make_waymo_tree, waymo_overrides

EVAL_KEYS = ("abs_rel", "sq_rel", "rms", "log_rms", "d1", "d2", "d3")
LOSS = {"MonoDepth2": "rec_loss", "MotionLearning": "rgb_l1_loss", "Supervised": "silog_loss"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_waymo_tree(str(tmp_path_factory.mktemp("waymo")))


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # its import costs seconds and nothing here reads it
    monkeypatch.setattr(engine_defaults, "tensorboard_writer_or_none", lambda *a, **k: None)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _argv(tree, family, out):
    opts = waymo_overrides(tree, family) + [
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_EPOCHS", 1, "DATALOADER.NUM_WORKERS", 2,
        "TPU.COMPUTE_DTYPE", "float32", "OUTPUT_DIR", out]
    return ["--cfg", os.path.join(REPO, "projects", family, "configs", "resnet18_waymo.yaml"), *map(str, opts)]


def _check_run(run_dir, family):
    with open(os.path.join(run_dir, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "total_loss" in r]
    assert [r["iteration"] for r in steps] == [0], rows
    assert math.isfinite(steps[0]["total_loss"]) and math.isfinite(steps[0][LOSS[family]])
    evals = [r for r in rows if "kitti evaluator/abs_rel" in r]
    assert len(evals) == 1
    for band in ("kitti evaluator", "kitti evaluator (0-30m)", "kitti evaluator (30-50m)", "kitti evaluator (50-80m)"):
        assert all(math.isfinite(evals[0][f"{band}/{k}"]) for k in EVAL_KEYS), band
    assert os.path.isfile(os.path.join(run_dir, "model_0000.pth"))
    return {k[len("kitti evaluator/"):]: v for k, v in evals[0].items() if k.startswith("kitti evaluator/")}


@pytest.mark.parametrize("family", ["MonoDepth2", "MotionLearning", "Supervised"])
def test_train_torch_on_waymo(tree, family, tmp_path):
    entry = _module(os.path.join(REPO, "projects", family, "train_torch.py"), f"train_torch_{family}")
    argv = _argv(tree, family, str(tmp_path))

    def main(extra):
        return simple_main(default_argument_parser().parse_args(extra + argv), entry.train, entry.test)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    state = main(["--device", "cpu"])
    assert state.step == 1 and next(state.model.parameters()).device.type == "cpu"
    run_dir = os.path.join(str(tmp_path), f"{family}_resnet18_waymo")
    last = _check_run(run_dir, family)
    results = main(["--device", "cpu", "--eval"])
    assert results["kitti evaluator"] == last
    shutil.rmtree(run_dir)  # a checkpoint of ~130-190 MB


def test_train_net_torch_on_waymo(tree, tmp_path):
    tool = _module(os.path.join(REPO, "tools", "train_net_torch.py"), "train_net_torch_tool")
    argv = ["--device", "cpu", *_argv(tree, "MonoDepth2", str(tmp_path))]
    trainer = tool.main(argv)
    assert trainer.iter == 1 and trainer.state.step == 1
    run_dir = os.path.join(str(tmp_path), "MonoDepth2_resnet18_waymo")
    last = _check_run(run_dir, "MonoDepth2")
    assert tool.main(["--eval"] + argv)["kitti evaluator"] == last
    shutil.rmtree(run_dir)
