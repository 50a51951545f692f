"""The port as a package: it imports without JAX, loads every shared yaml,
refuses to build on a missing CUDA device, and its GPU smoke script fails
where there is no GPU."""

import glob
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


def test_every_module_imports_without_jax():
    names = _module_names()
    assert len(names) >= 24
    assert {"simpledepthestimation_tpu_torch.solver.build",
            "simpledepthestimation_tpu_torch.parallel.train_step"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"names = {names!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'simpledepthestimation_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_do_not_name_jax():
    """Static twin of the subprocess test: no import statement of the port or
    of chip_smoke.py names JAX or the JAX package."""
    import re

    files = glob.glob(os.path.join(REPO, "simpledepthestimation_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|optax|orbax|simpledepthestimation_tpu)\b", re.M)
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


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
