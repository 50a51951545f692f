"""The port's ``utils/{memory,file_io,serialize,colormap}.py``, the image and
histogram half of ``utils/events.py`` and the RGB PNG writer, on the CPU,
mirroring ``tests/test_utils_misc.py`` where the JAX package has a test.

``put_image_with_cmap`` is held byte-equal to the JAX package's, which colours
through matplotlib (skipped without it); the port carries matplotlib's magma
table itself, because the GPU machine has no matplotlib.
"""

import pickle

import numpy as np
import pytest
import torch

from simpledepthestimation_tpu.utils.events import EventStorage as JaxEventStorage
from simpledepthestimation_tpu_torch.data.png import read_png, write_png
from simpledepthestimation_tpu_torch.utils import file_io
from simpledepthestimation_tpu_torch.utils.colormap import MAGMA, magma, magma_u8
from simpledepthestimation_tpu_torch.utils.events import EventStorage, TensorboardWriter, write_all
from simpledepthestimation_tpu_torch.utils.memory import retry_if_oom, to_device, to_numpy
from simpledepthestimation_tpu_torch.utils.serialize import PicklableWrapper


def test_to_numpy_and_device():
    tree = {"a": torch.ones(2, 2), "b": [torch.zeros(3), "keep"], "c": (np.arange(3),)}
    out = to_numpy(tree)
    assert isinstance(out["a"], np.ndarray) and isinstance(out["b"][0], np.ndarray)
    assert out["b"][1] == "keep" and isinstance(out["c"], tuple)
    back = to_device(out, "cpu")
    assert isinstance(back["a"], torch.Tensor) and back["a"].device.type == "cpu"
    assert torch.equal(back["c"][0], torch.arange(3)) and back["b"][1] == "keep"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            to_device(out)  # the card unless another device is named


def test_picklable_wrapper_lambda():
    w = PicklableWrapper(lambda x: x * 3)
    w2 = pickle.loads(pickle.dumps(w))
    assert w2(4) == 12


def test_file_io_scheme(tmp_path, monkeypatch):
    monkeypatch.setenv("SDE_TPU_MODEL_ZOO", str(tmp_path))
    p = file_io.get_local_path("sde-tpu://weights/r18.pth")
    assert p == str(tmp_path / "weights/r18.pth")
    assert file_io.get_local_path("/plain/path") == "/plain/path"
    file_io.mkdirs("sde-tpu://weights")
    with file_io.open_file("sde-tpu://weights/r18.pth", "w") as f:
        f.write("x")
    assert file_io.exists("sde-tpu://weights/r18.pth")


def test_retry_if_oom(monkeypatch):
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    calls = []

    @retry_if_oom
    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return 42

    assert flaky() == 42 and len(calls) == 2 and emptied == [1]

    @retry_if_oom
    def broken():
        raise ValueError("unrelated")

    with pytest.raises(ValueError):
        broken()
    assert emptied == [1]


def test_magma_matches_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    cmap = matplotlib.colormaps["magma"]
    x = np.concatenate([np.random.RandomState(0).rand(4096), [0.0, 1.0, -0.5, 1.5, np.nan, 255 / 256]])
    np.testing.assert_array_equal(magma(x), cmap(x)[..., :3])
    np.testing.assert_array_equal(magma_u8(x.astype(np.float32)), (cmap(x.astype(np.float32))[..., :3] * 255).astype(np.uint8))
    assert MAGMA.shape == (256, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_put_image_with_cmap_equals_the_jax_package(seed):
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(seed)
    depth = (rng.rand(1, 24, 40, 1) * 80).astype(np.float32)
    if seed == 2:
        depth[:] = 3.0  # a flat map: range 0
    with JaxEventStorage(5) as js:
        js.put_image_with_cmap("train/depth_pred", depth, cmap="magma")
    with EventStorage(5) as ts:
        ts.put_image_with_cmap("train/depth_pred", depth[0, ..., 0], cmap="magma")
    ((jn, ji, jit),), ((tn, ti, tit),) = js._vis_data, ts._vis_data
    assert (tn, tit) == (jn, jit) and ti.dtype == ji.dtype == np.uint8 and ti.shape == ji.shape == (24, 40, 3)
    np.testing.assert_array_equal(ti, ji)


class _FakeSummaryWriter:
    def __init__(self):
        self.calls = []

    def add_scalar(self, *args):
        self.calls.append(("scalar",) + args)

    def add_image(self, name, img, step, dataformats):
        self.calls.append(("image", name, img.shape, step, dataformats))

    def add_histogram_raw(self, tag, num, global_step, **kwargs):
        self.calls.append(("histogram", tag, num, global_step))


def test_images_and_histograms_reach_tensorboard_and_leave_the_storage():
    writer = TensorboardWriter.__new__(TensorboardWriter)  # no tensorboard import: a recording writer
    writer._window_size, writer._last_write, writer._writer = 20, -1, _FakeSummaryWriter()
    with EventStorage(3) as storage:
        storage.put_scalar("loss", 1.0)
        storage.put_image("train/image", np.zeros((8, 10, 3), np.uint8))
        storage.put_image("chw", np.zeros((3, 8, 10), np.float32))
        storage.put_histogram("h", np.arange(100.0), bins=10)
        write_all([writer])
        assert storage._vis_data == [] and storage._histograms == []
    assert writer._writer.calls == [
        ("scalar", "loss", 1.0, 3), ("image", "train/image", (8, 10, 3), 3, "HWC"),
        ("image", "chw", (3, 8, 10), 3, "CHW"), ("histogram", "h", 100, 3)]
    # without a writer that takes them, a write round drops them all the same
    with EventStorage(0) as storage:
        storage.put_image("train/image", np.zeros((2, 2, 3), np.uint8))
        storage.put_histogram("h", np.arange(4.0))
        write_all([])
        assert storage._vis_data == [] and storage._histograms == []


def test_png_rgb_writer(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"))[..., ::-1], img)
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "b.png"), img.astype(np.float32))
