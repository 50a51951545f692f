"""``tools/import_torch_checkpoint_torch.py`` against the JAX package's
importer (``models/torch_import.py``), on a seeded port model's
``state_dict`` taken as the original code's (its names; BtsModel's trunk under
``encoder.base_model``), perturbed so that it differs from any fresh init.

- Per family (MonoDepth2 R18, MotionLearning R18 randLN, Supervised R18,
  BTS-R50, PackNet01-1A): the JAX package's ``convert_meta_arch`` of the file,
  taken back to the port's names by ``models/flax_import.flax_to_state_dict``,
  equals the weights in the checkpoint the twin wrote, to the bit.
- The refusals agree: a missing key, a tensor of another shape and
  ``GoogleResNetv2`` are refused on both sides, the first two naming the
  tensor; an entry that neither reads is logged by the twin and ignored by
  both; a Checkpointer payload (``{"model": ...}``) with
  ``num_batches_tracked`` counters imports as the bare ``state_dict``.
- ``--resume`` from the imported file starts at ``epoch + 1`` with a fresh
  optimizer, and ``--eval`` reads its weights.
- Where the twin differs on purpose: it reads the file with ``weights_only``,
  so a file that pickles other objects (a numpy array) is refused.

All numpy on the JAX side: no Flax ``init``.
"""

import importlib.util
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from simpledepthestimation_tpu.models.torch_import import apply_torch_checkpoint, convert_meta_arch
from simpledepthestimation_tpu_torch.engine import default_argument_parser, simple_main
from simpledepthestimation_tpu_torch.engine import defaults as engine_defaults
from simpledepthestimation_tpu_torch.engine.runtime import restore_inference_state
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict

from torch_port_helpers import REPO, reference_state_dict, to_numpy_tree


def _yaml(*parts):
    return os.path.join(REPO, "projects", *parts)


FAMILIES = {
    "monodepth2_r18": _yaml("MonoDepth2", "configs", "resnet18.yaml"),
    "motionlearning_r18_randln": _yaml("MotionLearning", "configs", "resnet18.yaml"),
    "supervised_r18": _yaml("Supervised", "configs", "resnet18.yaml"),
    "bts_r50": _yaml("Supervised", "configs", "bts_r50.yaml"),
    "packnet_1a": _yaml("MonoDepth2", "configs", "packnet_1a.yaml"),
}


def _cfgs(yaml, opts=()):
    from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
    from simpledepthestimation_tpu_torch.config import get_cfg

    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(yaml)
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return out


def _tool():
    path = os.path.join(REPO, "tools", "import_torch_checkpoint_torch.py")
    spec = importlib.util.spec_from_file_location("import_torch_checkpoint_torch_tool", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _original_state_dict(cfg, seed=7):
    """A seeded port model's weights under the original code's names, every float
    tensor scaled by 1 + 0.1 N(0, 1) (seeded numpy): no init gives them."""
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in reference_state_dict(model.state_dict(), cfg).items():
        if v.is_floating_point():
            noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
            v = v * (1.0 + 0.1 * torch.from_numpy(noise))
        sd[k] = v.clone()
    return sd


def _import(tmp_path, yaml, sd, epoch=3, opts=()):
    weights = str(tmp_path / "original.pth")
    torch.save(sd, weights)
    out = str(tmp_path / "imported")
    path = _tool().main(["--cfg", yaml, "--weights", weights, "--output", out, "--epoch", str(epoch),
                         "--device", "cpu", *opts])
    assert path == os.path.join(out, f"model_{epoch:04d}.pth")
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read().strip() == f"model_{epoch:04d}.pth"
    return torch.load(path, map_location="cpu", weights_only=True), out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_imported_weights_equal_the_jax_converter(tmp_path, family):
    cfg_jax, cfg = _cfgs(FAMILIES[family])
    sd = _original_state_dict(cfg)
    if family == "monodepth2_r18":  # the original Checkpointer's payload, counters included
        payload = {"model": sd, "optimizer": {}, "iteration": 1234}
        assert any(k.endswith("num_batches_tracked") for k in sd)
    else:
        payload = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    ckpt, out = _import(tmp_path, FAMILIES[family], payload)
    numpy_sd = {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    params, stats = convert_meta_arch(numpy_sd, cfg_jax)
    want = flax_to_state_dict(to_numpy_tree(params), to_numpy_tree(stats))
    got = {k: v for k, v in ckpt["model"].items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert ckpt["epoch"] == 3 and ckpt["step"] == 0 and ckpt["optimizer"]["state"] == {}
    os.remove(os.path.join(out, "model_0003.pth"))  # PackNet's is 0.5 GB


def _refusal(tool, jax_variables, sd, cfg_jax, cfg):
    """The exception each side raises on ``sd``."""
    model = build_model(cfg, device="cpu")
    errors = []
    for fn in (lambda: apply_torch_checkpoint(jax_variables, {k: v.numpy() for k, v in sd.items()}, cfg_jax),
               lambda: tool.apply_original_state_dict(model, tool.original_state_dict(sd), cfg)):
        with pytest.raises(Exception) as e:
            fn()
        errors.append(e.value)
    return errors


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_refusals_and_ignored_entries_agree_with_jax():
    tool = _tool()
    cfg_jax, cfg = _cfgs(FAMILIES["monodepth2_r18"])
    sd = {k: v for k, v in _original_state_dict(cfg).items() if not k.endswith("num_batches_tracked")}
    params, stats = convert_meta_arch({k: v.numpy() for k, v in sd.items()}, cfg_jax)
    variables = {"params": to_numpy_tree(params), "batch_stats": to_numpy_tree(stats)}

    key = "depth_net.decoder.decoder.13.conv.weight"
    missing = {k: v for k, v in sd.items() if k != key}
    jax_err, port_err = _refusal(tool, variables, missing, cfg_jax, cfg)
    assert isinstance(jax_err, (KeyError, ValueError)) and isinstance(port_err, ValueError)
    assert "decoder.13.conv.weight" in str(jax_err) and key in str(port_err)

    wrong = dict(sd, **{key: sd[key][:, :-1]})
    jax_err, port_err = _refusal(tool, variables, wrong, cfg_jax, cfg)
    assert isinstance(jax_err, ValueError) and "shape mismatch" in str(jax_err)
    assert isinstance(port_err, ValueError) and key in str(port_err) and "shape mismatch" in str(port_err)

    # an entry neither side reads: the JAX importer ignores it silently, the twin logs it
    extra = dict(sd, **{"depth_net.extra.weight": torch.zeros(3), "pixel_mean": torch.zeros(3)})
    apply_torch_checkpoint(variables, {k: v.numpy() for k, v in extra.items()}, cfg_jax)
    model = build_model(cfg, device="cpu")
    records = _Records()
    tool.logger.addHandler(records)
    try:
        ignored = tool.apply_original_state_dict(model, tool.original_state_dict(extra), cfg)
    finally:
        tool.logger.removeHandler(records)
    assert ignored == ["depth_net.extra.weight", "pixel_mean"]
    assert any("depth_net.extra.weight" in m and "pixel_mean" in m for m in records.messages)
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items() if k in sd)

    # a pose net's entries for a model without one: refused for the pose net's name (none in the
    # Supervised yaml), or, where the config names one, by the JAX tree match and by the twin
    for opts, error in (((), NotImplementedError), (("MODEL.POSE_NET.NAME", "PoseNet"), ValueError)):
        sup_jax, sup = _cfgs(FAMILIES["supervised_r18"], opts)
        sup_sd = {k: v for k, v in _original_state_dict(sup).items() if not k.endswith("num_batches_tracked")}
        sup_params, sup_stats = convert_meta_arch({k: v.numpy() for k, v in sup_sd.items()}, sup_jax)
        with_pose = dict(sup_sd, **{k: v for k, v in sd.items() if k.startswith("pose_net.")})
        jax_err, port_err = _refusal(
            tool, {"params": to_numpy_tree(sup_params), "batch_stats": to_numpy_tree(sup_stats)}, with_pose, sup_jax,
            sup)
        assert type(jax_err) is type(port_err) is error and "pose" in str(jax_err) and "pose" in str(port_err)


def test_a_file_that_pickles_other_objects_is_refused(tmp_path):
    """The twin reads with ``weights_only``: a payload holding a numpy array is
    refused before any model is built (the JAX package's tool unpickles it)."""
    import pickle

    sd = {"depth_net.x.weight": torch.zeros(2)}
    torch.save({"model": sd, "extra": np.zeros(3)}, tmp_path / "original.pth")
    with pytest.raises(pickle.UnpicklingError):
        _tool().main(["--cfg", FAMILIES["monodepth2_r18"], "--weights", str(tmp_path / "original.pth"),
                      "--output", str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def test_googleresnetv2_is_refused_on_both_sides():
    tool = _tool()
    opts = ("MODEL.DEPTH_NET.NAME", "GoogleResNetv2", "MODEL.POSE_NET.NAME", "GooglePoseNet")
    cfg_jax, cfg = _cfgs(FAMILIES["motionlearning_r18_randln"], opts)
    model = build_model(cfg, device="cpu")
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    with pytest.raises(NotImplementedError, match="GoogleResNetv2"):
        convert_meta_arch({k: v.numpy() for k, v in sd.items()}, cfg_jax)
    with pytest.raises(NotImplementedError, match="GoogleResNetv2"):
        tool.apply_original_state_dict(model, sd, cfg)


def test_resume_and_eval_read_the_imported_checkpoint(tmp_path, monkeypatch):
    """Imported as epoch 1 into the run directory of ``synthetic_quick.yaml``:
    ``--resume`` trains epoch 2 only, from the imported weights and a fresh
    optimizer; ``--eval`` reads the weights."""
    monkeypatch.setattr(engine_defaults, "tensorboard_writer_or_none", lambda *a, **k: None)
    yaml = _yaml("MonoDepth2", "configs", "synthetic_quick.yaml")
    opts = ["DATASETS.TRAIN.IMG_HEIGHT", "64", "DATASETS.TRAIN.IMG_WIDTH", "96", "DATASETS.TRAIN.LENGTH", "2",
            "DATASETS.TEST.IMG_HEIGHT", "64", "DATASETS.TEST.IMG_WIDTH", "96", "DATASETS.TEST.LENGTH", "1",
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_EPOCHS", "3", "TPU.COMPUTE_DTYPE", "float32",
            "DATALOADER.NUM_WORKERS", "1", "OUTPUT_DIR", str(tmp_path / "runs")]
    _, cfg = _cfgs(yaml, opts)
    sd = _original_state_dict(cfg)
    run_dir = tmp_path / "runs" / "MonoDepth2_synthetic_quick"
    weights = str(tmp_path / "original.pth")
    torch.save(sd, weights)
    _tool().main(["--cfg", yaml, "--weights", weights, "--output", str(run_dir), "--epoch", "1", "--device", "cpu",
                  *opts])

    sys.path.insert(0, _yaml("MonoDepth2"))
    try:
        import train_torch  # projects/MonoDepth2/train_torch.py
    finally:
        sys.path.pop(0)

    def main(extra):
        return simple_main(default_argument_parser().parse_args(extra + ["--cfg", yaml, *opts]),
                           train_torch.train, train_torch.test)

    state, _ = restore_inference_state(
        _cfgs(yaml, opts + ["OUTPUT_DIR", str(run_dir)])[1], device="cpu")
    assert all(torch.equal(v, sd[k]) for k, v in state.model.state_dict().items())
    results = main(["--device", "cpu", "--eval"])
    assert all(np.isfinite(v) for v in results["kitti evaluator"].values())

    trained = main(["--device", "cpu", "--resume"])
    assert trained.step == 1  # one step of epoch 2, on a fresh optimizer (step 0 in the import)
    with open(run_dir / "metrics.json") as f:
        rows = [json.loads(line) for line in f]
    assert [r["iteration"] for r in rows if "total_loss" in r] == [2]  # epoch 2 of one step an epoch
    assert sorted(p.name for p in run_dir.iterdir() if p.name.startswith("model_")) == ["model_0001.pth",
                                                                                         "model_0002.pth"]
