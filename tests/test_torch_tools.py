"""The four tools' twins (``tools/{train_net,plain_train_net,export_inference,demo}_torch.py``)
run in this process with ``--device cpu`` on the synthetic configs at a tiny
size (one step an epoch): what each writes, ``--eval`` reproducing the last
evaluation row of training, the exported program equal to eager, the demo's
panels, and the demo without OpenCV: JPEG frames read by the port's reader,
``--video`` refused.

The hook path on a MotionLearning config runs as the JAX package's
``DefaultTrainer`` does: without the noise and burn-in schedule (the model's
defaults, noise 0 and motion weight 1), and PreciseBN finds no BatchNorm to
recompute (RandLayerNorm and no norm in the motion net).
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from simpledepthestimation_tpu_torch.data.png import read_png, write_png
from simpledepthestimation_tpu_torch.engine.export import InferenceModule, load_exported

from torch_port_helpers import REPO

MONO_YAML = os.path.join(REPO, "projects", "MonoDepth2", "configs", "synthetic_quick.yaml")
MOTION_YAML = os.path.join(REPO, "projects", "MotionLearning", "configs", "synthetic_quick.yaml")
H, W = 64, 96
TINY = ["DATASETS.TRAIN.IMG_HEIGHT", H, "DATASETS.TRAIN.IMG_WIDTH", W, "DATASETS.TRAIN.LENGTH", 2,
        "DATASETS.TEST.IMG_HEIGHT", H, "DATASETS.TEST.IMG_WIDTH", W, "DATASETS.TEST.LENGTH", 1,
        "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_EPOCHS", 1, "TEST.EVAL_PERIOD", 1, "TPU.COMPUTE_DTYPE", "float32",
        "DATALOADER.NUM_WORKERS", 1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch_tool", os.path.join(REPO, "tools", f"{name}_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def _last_eval(rows):
    row = [r for r in rows if "kitti evaluator/abs_rel" in r][-1]
    return {k[len("kitti evaluator/"):]: v for k, v in row.items() if k.startswith("kitti evaluator/")}


def test_train_net_hook_path_on_motionlearning(tmp_path):
    tool = _tool("train_net")
    argv = ["--device", "cpu", "--cfg", MOTION_YAML, *map(str, TINY), "OUTPUT_DIR", str(tmp_path),
            "TEST.PRECISE_BN.ENABLED", "True", "TPU.PROFILE_ITERS", "(0,)"]
    trainer = tool.main(argv)
    run_dir = os.path.join(str(tmp_path), "MotionLearning_synthetic_quick")
    rows = _rows(run_dir)
    assert [r["iteration"] for r in rows if "total_loss" in r] == [0]
    assert trainer.iter == 1 and trainer.state.step == 1
    assert os.path.isfile(os.path.join(run_dir, "model_0000.pth"))
    assert os.path.getsize(os.path.join(run_dir, "profiler-trace-iter0", "trace.json")) > 0
    assert trainer.start_epoch == 0
    precise = [h for h in trainer._hooks if type(h).__name__ == "PreciseBN"]
    assert len(precise) == 1 and precise[0]._disabled  # no BatchNorm in this model
    results = tool.main(["--eval"] + argv)
    assert results["kitti evaluator"] == _last_eval(rows)
    shutil.rmtree(run_dir)  # a checkpoint of ~190 MB


@pytest.fixture(scope="module")
def mono_run(tmp_path_factory):
    """One epoch of one MonoDepth2 step through plain_train_net_torch.py."""
    out = tmp_path_factory.mktemp("plain")
    tool = _tool("plain_train_net")
    argv = ["--device", "cpu", "--cfg", MONO_YAML, *map(str, TINY), "OUTPUT_DIR", str(out)]
    state = tool.main(argv)
    run_dir = os.path.join(str(out), "MonoDepth2_synthetic_quick")
    yield dict(tool=tool, argv=argv, state=state, run_dir=run_dir, out=out)
    shutil.rmtree(out, ignore_errors=True)  # a checkpoint of ~190 MB and the exported program


def test_plain_train_net(mono_run):
    rows = _rows(mono_run["run_dir"])
    assert [r["iteration"] for r in rows if "total_loss" in r] == [0] and mono_run["state"].step == 1
    results = mono_run["tool"].main(["--eval"] + mono_run["argv"])
    assert results["kitti evaluator"] == _last_eval(rows)


def test_export_inference_tool(mono_run):
    path = str(mono_run["out"] / "model.pt2")
    tool = _tool("export_inference")
    assert tool.main(["--device", "cpu", "--cfg", MONO_YAML, "--output", path, *map(str, TINY),
                      "MODEL.WEIGHTS", mono_run["run_dir"]]) == path
    meta = json.load(open(path + ".json"))
    assert meta["input"]["shape"] == [1, 3, H, W] and meta["depth_net"] == "DepthResNet"
    img = torch.from_numpy(np.random.RandomState(0).rand(1, 3, H, W).astype(np.float32))
    trained = mono_run["state"]  # the state of the checkpoint the tool exported
    with torch.no_grad():
        eager = InferenceModule(trained.model)(img)
    assert torch.equal(load_exported(path)(img), eager)
    with pytest.raises(FileNotFoundError, match="random-init"):
        tool.main(["--device", "cpu", "--cfg", MONO_YAML, "--output", path, *map(str, TINY),
                   "OUTPUT_DIR", str(mono_run["out"] / "nothing")])


def test_demo_writes_one_panel_per_png(mono_run, tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(2)]
    for i, img in enumerate(imgs):
        write_png(str(frames / f"{i}.png"), img)
    tool = _tool("demo")
    written = tool.main(["--device", "cpu", "--cfg", MONO_YAML, "--input", str(frames), "--output",
                         str(tmp_path / "out"), *map(str, TINY), "MODEL.WEIGHTS", mono_run["run_dir"]])
    assert [os.path.basename(p) for p in written] == ["0.png", "1.png"]
    for img, path in zip(imgs, written):
        panel = read_png(path)
        assert panel.shape == (2 * H, W, 3) and panel.dtype == np.uint8
        np.testing.assert_array_equal(panel[:H], img)
        assert len(np.unique(panel[H:].reshape(-1, 3), axis=0)) > 1  # a coloured depth map under the frame


@pytest.mark.parametrize("case", ["jpeg_reads_as_its_png_copy", "video_refused"])
def test_demo_refuses_jpeg_and_video_without_opencv(mono_run, tmp_path, monkeypatch, case):
    """Without OpenCV: JPEG frames are read by the port's reader and give the
    panels that their decoded pixels give as PNG files; ``--video`` is refused."""
    from PIL import Image

    from simpledepthestimation_tpu_torch.data.jpeg import read_jpeg

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    tool = _tool("demo")
    common = ["--device", "cpu", "--cfg", MONO_YAML, *map(str, TINY), "MODEL.WEIGHTS", mono_run["run_dir"]]
    if case == "video_refused":
        write_png(str(tmp_path / "b.png"), np.zeros((H, W, 3), np.uint8))
        with pytest.raises(SystemExit, match="cv2"):
            tool.main(["--input", str(tmp_path / "b.png"), "--output", str(tmp_path / "out"), "--video", *common])
        assert not os.path.exists(tmp_path / "out")
        return
    jpegs, pngs = tmp_path / "jpeg", tmp_path / "png"
    jpegs.mkdir()
    pngs.mkdir()
    rng = np.random.RandomState(4)
    for i in range(2):
        Image.fromarray(rng.randint(0, 256, (H, W, 3)).astype(np.uint8)).save(str(jpegs / f"{i}.jpg"))
        write_png(str(pngs / f"{i}.png"), read_jpeg(str(jpegs / f"{i}.jpg")))
    from_jpeg = tool.main(["--input", str(jpegs), "--output", str(tmp_path / "out_jpeg"), *common])
    from_png = tool.main(["--input", str(pngs), "--output", str(tmp_path / "out_png"), *common])
    assert [os.path.basename(p) for p in from_jpeg] == [os.path.basename(p) for p in from_png] == ["0.png", "1.png"]
    for a, b in zip(from_jpeg, from_png):
        panel = read_png(a)
        assert panel.shape == (2 * H, W, 3)
        np.testing.assert_array_equal(panel, read_png(b))
