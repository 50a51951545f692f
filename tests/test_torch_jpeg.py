"""The port's JPEG reader (``simpledepthestimation_tpu_torch/data/jpeg.py``)
against ``cv2.imread`` + BGR→RGB, which the JAX package reads frames with.

Limit: equal, byte for byte, on every case: 4:2:0, 4:2:2 and 4:4:4 chroma,
progressive, a restart interval, quality 95, a file OpenCV wrote, gray, at a
size that is no whole number of MCUs (1281x1917), and EXIF orientations 1-8
(``imread`` turns the frame; so does the reader). CMYK raises (Pillow's and
OpenCV's CMYK→RGB differ), as do a missing file, a file that is no image and
a reader without Pillow. ``LoadImg`` picks the reader by the first bytes, so a
PNG named ``.jpg`` and a JPEG named ``.png`` read as ``imread`` reads them;
reading a PNG never imports Pillow.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from simpledepthestimation_tpu_torch.data.jpeg import read_jpeg
from simpledepthestimation_tpu_torch.data.png import write_png
from simpledepthestimation_tpu_torch.data.preprocess.loading import LoadImg

from torch_port_helpers import REPO

ORIENTATION = 0x0112  # the EXIF tag


def _smooth(rng, h, w):
    """A smooth colour field: the 8x8 blocks keep detail at every quality."""
    low = rng.random((h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
    return (cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).clip(0, 1) * 255).astype(np.uint8)


def _imread_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def frame():
    return _smooth(np.random.default_rng(0), 1281, 1917)


ENCODINGS = {
    "420": lambda img, p: Image.fromarray(img).save(p, subsampling=2),
    "422": lambda img, p: Image.fromarray(img).save(p, subsampling=1),
    "444": lambda img, p: Image.fromarray(img).save(p, subsampling=0),
    "progressive": lambda img, p: Image.fromarray(img).save(p, progressive=True),
    "quality95": lambda img, p: Image.fromarray(img).save(p, quality=95),
    "restart_interval": lambda img, p: cv2.imwrite(p, img[..., ::-1], [cv2.IMWRITE_JPEG_RST_INTERVAL, 4]),
    "written_by_opencv": lambda img, p: cv2.imwrite(p, img[..., ::-1]),
    "gray": lambda img, p: Image.fromarray(img[..., 1]).save(p),
}


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
def test_reader_equals_cv2_imread(tmp_path, frame, encoding):
    path = str(tmp_path / "f.jpg")
    ENCODINGS[encoding](frame, path)
    if encoding == "restart_interval":
        with open(path, "rb") as f:
            assert b"\xff\xdd" in f.read()  # a DRI marker
    got = read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == (1281, 1917, 3) and got.flags.writeable
    np.testing.assert_array_equal(got, _imread_rgb(path))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_imread(tmp_path, orientation):
    img = _smooth(np.random.default_rng(orientation), 64, 96)
    exif = Image.Exif()
    exif[ORIENTATION] = orientation
    path = str(tmp_path / "o.jpg")
    Image.fromarray(img).save(path, exif=exif)
    got = read_jpeg(path)
    assert got.shape == ((96, 64, 3) if orientation >= 5 else (64, 96, 3))
    np.testing.assert_array_equal(got, _imread_rgb(path))


def test_refusals(tmp_path, monkeypatch):
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_smooth(np.random.default_rng(1), 32, 48)).convert("CMYK").save(cmyk)
    with pytest.raises(ValueError, match="CMYK"):
        read_jpeg(cmyk)
    with pytest.raises(ValueError, match="CMYK"):
        LoadImg._load(cmyk)
    with pytest.raises(FileNotFoundError):
        read_jpeg(str(tmp_path / "missing.jpg"))
    with pytest.raises(FileNotFoundError):
        LoadImg._load(str(tmp_path / "missing.jpg"))
    text = tmp_path / "notes.jpg"
    text.write_bytes(b"not an image at all\n")
    with pytest.raises(ValueError, match="not a JPEG"):
        read_jpeg(str(text))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        LoadImg._load(str(text))
    assert cv2.imread(str(text)) is None  # OpenCV reads nothing either
    good = str(tmp_path / "good.jpg")
    Image.fromarray(_smooth(np.random.default_rng(2), 16, 16)).save(good)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL raises ImportError
    with pytest.raises(ImportError, match="Pillow"):
        read_jpeg(good)


def test_load_img_reads_by_content_not_name(tmp_path):
    rng = np.random.default_rng(3)
    img = _smooth(rng, 40, 72)
    png_as_jpg, jpg_as_png = str(tmp_path / "a.jpg"), str(tmp_path / "b.png")
    write_png(png_as_jpg, img)
    Image.fromarray(img).save(jpg_as_png, format="JPEG")
    np.testing.assert_array_equal(LoadImg._load(png_as_jpg), img)
    np.testing.assert_array_equal(LoadImg._load(png_as_jpg), _imread_rgb(png_as_jpg))
    np.testing.assert_array_equal(LoadImg._load(jpg_as_png), _imread_rgb(jpg_as_png))
    assert not np.array_equal(LoadImg._load(jpg_as_png), img)  # lossy: it was decoded as JPEG


def test_pillow_is_imported_only_to_read_a_jpeg(tmp_path):
    img = _smooth(np.random.default_rng(4), 8, 8)
    write_png(str(tmp_path / "a.png"), img)
    Image.fromarray(img).save(str(tmp_path / "b.jpg"))
    code = (
        "import sys\n"
        "import simpledepthestimation_tpu_torch\n"
        "from simpledepthestimation_tpu_torch.data.preprocess.loading import LoadImg\n"
        f"LoadImg._load({str(tmp_path / 'a.png')!r})\n"
        "print('PIL' in sys.modules)\n"
        f"LoadImg._load({str(tmp_path / 'b.jpg')!r})\n"
        "print('PIL' in sys.modules)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "True"]
