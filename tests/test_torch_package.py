"""The port as a package: it imports without JAX, loads every shared yaml,
refuses to build on a missing CUDA device, and its GPU smoke script fails
where there is no GPU."""

import glob
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

from torch_port_helpers import REPO

CONFIGS = sorted(glob.glob(os.path.join(REPO, "projects", "*", "configs", "*.yaml")))


def _module_names():
    import simpledepthestimation_tpu_torch as pkg

    return sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")
    )


ENTRY_POINTS = sorted(glob.glob(os.path.join(REPO, "projects", "*", "train_torch.py")))
TOOLS = sorted(glob.glob(os.path.join(REPO, "tools", "*_torch.py")))


@pytest.fixture(scope="module")
def loaded_modules():
    """Every module of the port, the ``train_torch.py`` entry points and the
    ``tools/*_torch.py`` twins, imported in a fresh interpreter: the top-level
    names of everything that came with them."""
    names = _module_names()
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"names = {names!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        f"for i, path in enumerate({ENTRY_POINTS + TOOLS!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'entry_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return names, set(json.loads(res.stdout.strip().splitlines()[-1]))


def _sources():
    files = glob.glob(os.path.join(REPO, "simpledepthestimation_tpu_torch", "**", "*.py"), recursive=True)
    return files + [os.path.join(REPO, "chip_smoke.py")] + ENTRY_POINTS + TOOLS


def _assert_no_import(pattern, exempt=()):
    import re

    pat = re.compile(r"^\s*(from|import)\s+(" + pattern + r")\b", re.M)
    for path in _sources():
        if os.path.relpath(path, REPO) in exempt:
            continue
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_every_module_imports_without_jax(loaded_modules):
    names, loaded = loaded_modules
    assert len(names) >= 40
    assert {"simpledepthestimation_tpu_torch.solver.build",
            "simpledepthestimation_tpu_torch.parallel.train_step",
            "simpledepthestimation_tpu_torch.data.preprocess.augmentation",
            "simpledepthestimation_tpu_torch.evaluation.depth_evaluation",
            "simpledepthestimation_tpu_torch.engine.runtime",
            "simpledepthestimation_tpu_torch.utils.events",
            "simpledepthestimation_tpu_torch.models.bts",
            "simpledepthestimation_tpu_torch.models.encoders",
            "simpledepthestimation_tpu_torch.data.jpeg",
            "simpledepthestimation_tpu_torch.data.datasets.waymo",
            "simpledepthestimation_tpu_torch.data.datasets.waymo_extract",
            "simpledepthestimation_tpu_torch.parallel.mesh",
            "simpledepthestimation_tpu_torch.utils.comm"} <= set(names)
    assert {os.path.relpath(p, REPO) for p in ENTRY_POINTS} == {
        f"projects/{family}/train_torch.py" for family in ("MonoDepth2", "MotionLearning", "Supervised")}
    assert {os.path.relpath(p, REPO) for p in TOOLS} == {
        f"tools/{name}_torch.py" for name in ("train_net", "plain_train_net", "export_inference", "demo",
                                              "import_torch_checkpoint")}
    bad = loaded & {"jax", "jaxlib", "flax", "optax", "orbax"}
    assert not bad, bad


def test_sources_do_not_name_jax():
    """Static twin of the subprocess test: no import statement of the port, of
    chip_smoke.py, of the ``train_torch.py`` entry points or of the
    ``tools/*_torch.py`` twins names JAX or the JAX package."""
    _assert_no_import("jax|flax|optax|orbax|simpledepthestimation_tpu")


def test_nothing_imports_the_jax_package(loaded_modules):
    _, loaded = loaded_modules
    assert "simpledepthestimation_tpu" not in loaded
    _assert_no_import("simpledepthestimation_tpu")


def test_nothing_imports_opencv(loaded_modules):
    """The data and evaluation code reads PNG and JPEG files, writes PNG files
    and resizes frames without OpenCV, which the GPU machine need not have. The
    demo imports it only for ``--video``, in one function, and refuses that
    without it; ``chip_smoke.py`` only to report its version and to hold the
    JPEG reader against ``cv2.imread`` where it imports, in two functions."""
    import re

    _, loaded = loaded_modules
    assert "cv2" not in loaded
    _assert_no_import("cv2", exempt=("tools/demo_torch.py", "chip_smoke.py"))
    pattern = re.compile(r"^(\s*)(?:from|import)\s+cv2\b", re.M)
    with open(os.path.join(REPO, "tools", "demo_torch.py")) as f:
        demo = f.read()
    assert pattern.findall(demo) == ["        "]  # one import, in the body of a function
    assert re.search(r"def _opencv\(\):\n    try:\n        import cv2\n", demo)
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        smoke = f.read()
    assert len(pattern.findall(smoke)) == 2 and all(indent for indent in pattern.findall(smoke))
    for function in ("environment_line", "phase_jpeg_agreement"):
        body = smoke[smoke.index(f"def {function}("):]
        body = body[:body.index("\ndef ")]
        assert pattern.search(body), function


def test_nothing_imports_pillow(loaded_modules):
    """Pillow is imported by the JPEG reader when it reads a JPEG file, never
    when a module is imported."""
    _, loaded = loaded_modules
    assert "PIL" not in loaded


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: "/".join(p.split("/")[-3:]))
def test_config_loads_under_port(path):
    from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
    from simpledepthestimation_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.freeze()
    ref = get_cfg_jax()
    ref.merge_from_file(path)
    assert cfg.to_dict() == ref.to_dict()
    assert cfg.TPU.COMPUTE_DTYPE in ("bfloat16", "float32")


def test_all_configs_found():
    names = {os.path.basename(p) for p in CONFIGS}
    assert {"resnet18.yaml", "bts_r50.yaml", "packnet_1a.yaml", "synthetic_quick.yaml"} <= names


def test_build_model_needs_cuda_unless_cpu_is_named():
    from torch_port_helpers import monodepth2_cfgs
    from simpledepthestimation_tpu_torch.models import build_model

    _, cfg = monodepth2_cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("name", ["bts_r50.yaml", "resnet18.yaml"])
def test_supervised_configs_build_on_cuda_unless_cpu_is_named(name):
    """The shipped Supervised configs as they stand: BtsModel-R50 and DepthResNet-18."""
    from torch_port_helpers import supervised_cfgs
    from simpledepthestimation_tpu_torch.models import build_model

    _, cfg = supervised_cfgs(name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert type(model.depth_net).__name__ == str(cfg.MODEL.DEPTH_NET.NAME)
    assert next(model.parameters()).device.type == "cpu"


def test_seeded_init_is_reproducible():
    from torch_port_helpers import monodepth2_cfgs
    from simpledepthestimation_tpu_torch.models import build_model

    _, cfg = monodepth2_cfgs()
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    c = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_kernel_wrappers_reject_unsupported_inputs():
    from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
    from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

    img = torch.zeros(2, 3, 4, 5)
    with pytest.raises(ValueError):
        warp_bilinear(img, torch.zeros(1, 4, 5), torch.zeros(1, 4, 5))
    with pytest.raises(ValueError):
        warp_bilinear(img[0], torch.zeros(2, 4, 5), torch.zeros(2, 4, 5))
    with pytest.raises(ValueError):
        photometric_map(img, torch.zeros(2, 3, 4, 6))
    with pytest.raises(ValueError, match="H, W >= 2"):
        photometric_map(torch.zeros(1, 3, 1, 8), torch.zeros(1, 3, 1, 8))
    # the launch counts move only where a kernel is launched: never on the CPU
    def counts():
        return (warp_bilinear.launches, photometric_map.launches,
                warp_bilinear.bwd_launches, photometric_map.bwd_launches)

    before = counts()
    x = torch.zeros(2, 4, 5, requires_grad=True)
    a = img.clone().requires_grad_()
    (warp_bilinear(img, x, torch.zeros(2, 4, 5)).sum() + photometric_map(a, img).sum()).backward()
    assert x.grad is not None and a.grad is not None
    assert counts() == before
