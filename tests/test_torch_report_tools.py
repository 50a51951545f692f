"""The report tools' twins (``tools/{bench_models,profile_step,trace_step,bench_loader}_torch.py``)
against the JAX tools: the same cases, configs and seeded batches (configs on
every key the two packages share, batches to the bit after NHWC -> NCHW), the
bench and the trace run with ``--device cpu`` at a tiny size, and the loader
tree written by OpenCV read by the port's loader into the JAX loader's first
batch. Nothing here compiles a JAX function."""

import ast
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import REPO

sys.path.insert(0, REPO)

from tools import bench_models as jax_bench  # noqa: E402  (numpy only at import; JAX inside its functions)

TWINS = ("bench_models", "profile_step", "trace_step", "bench_loader")


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch_tool", os.path.join(REPO, "tools", f"{name}_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bench():
    return _tool("bench_models")


def _flat(cfg, prefix=""):
    out = {}
    for k, v in cfg.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_same_cfg(port_cfg, jax_cfg):
    a, b = _flat(port_cfg), _flat(jax_cfg)
    shared = set(a) & set(b)
    assert len(shared) > 50 and set(b) <= set(a), sorted(set(b) - set(a))
    for k in sorted(shared):
        assert a[k] == b[k], (k, a[k], b[k])


def _assert_same_batch(port_batch, jax_batch):
    assert set(port_batch) == set(jax_batch)
    for k, jv in jax_batch.items():
        tv = port_batch[k]
        assert isinstance(tv, torch.Tensor) and tv.device.type == "cpu", k
        t = tv.numpy()
        if t.ndim == 4:
            t = t.transpose(0, 2, 3, 1)
        elif t.ndim == 5:
            t = t.transpose(0, 1, 3, 4, 2)
        jv = np.asarray(jv)
        assert t.dtype == jv.dtype and t.shape == jv.shape, k
        np.testing.assert_array_equal(t, jv, err_msg=k)


@pytest.mark.parametrize("case", jax_bench.CASES, ids=[c[0] for c in jax_bench.CASES])
def test_make_case_matches_the_jax_tool(bench, case):
    name, meta, dn, pose, B, H, W, opts = case
    assert case in bench.CASES  # the same shapes, batch sizes and per-case options
    port_cfg, port_batch = bench.make_case(meta, dn, pose, 2, 64, 128, opts, device="cpu")
    jax_cfg, jax_batch = jax_bench.make_case(meta, dn, pose, 2, 64, 128, opts)
    assert port_cfg.TPU.COMPUTE_DTYPE == jax_cfg.TPU.COMPUTE_DTYPE == "float32"
    _assert_same_cfg(port_cfg, jax_cfg)
    _assert_same_batch(port_batch, jax_batch)
    assert bool(port_cfg.TPU.REMAT) == (name == "BTS-R50")


def test_flagship_matches_graft_entry(bench):
    from __graft_entry__ import _tiny_cfg, _train_batch

    for dtype in ("float32", "bfloat16"):
        _assert_same_cfg(bench.flagship_cfg(dtype), _tiny_cfg(dtype))
    batch = bench.flagship_batch(3, 32, 48, device="cpu")
    _assert_same_batch(batch, _train_batch(3, 32, 48))
    assert batch["img_orig"] is batch["img"] and batch["ctx_img_orig"] is batch["ctx_img"]


def test_profile_step_variants_match_the_jax_tool():
    from __graft_entry__ import _tiny_cfg, _train_batch

    tool = _tool("profile_step")
    port = tool.variants("bfloat16")
    # tools/profile_step.py's variants, as it builds them
    ref = {"full (ssim+automask+min)": _tiny_cfg("bfloat16")}
    cfg = _tiny_cfg("bfloat16"); cfg.LOSS.SSIM_WEIGHT = 0.0  # noqa: E702
    ref["no-ssim"] = cfg
    cfg = _tiny_cfg("bfloat16"); cfg.LOSS.AUTOMASK = False  # noqa: E702
    ref["no-automask"] = cfg
    cfg = _tiny_cfg("bfloat16"); cfg.LOSS.SMOOTHNESS_WEIGHT = 0.0  # noqa: E702
    ref["no-smooth"] = cfg
    sup = _tiny_cfg("bfloat16")
    sup.MODEL.META_ARCHITECTURE = "SupDepthModel"
    ref["supervised-only (nets minus pose/warp)"] = sup
    assert list(port) == list(ref)
    for name in ref:
        _assert_same_cfg(port[name], ref[name])
    assert (tool.B, tool.H, tool.W, tool.WARM_STEPS, tool.STEPS) == (16, 192, 640, 3, 10)

    B, H, W = 2, 32, 48
    batch = _train_batch(B, H, W)
    ref_sup = {"img": batch["img"], "flip": batch["flip"],
               "depth": np.random.RandomState(0).uniform(1, 60, (B, H, W, 1)).astype(np.float32)}
    sup_batch = tool.supervised_batch(tool.flagship_batch(B, H, W, device="cpu"), B, H, W)
    _assert_same_batch(sup_batch, ref_sup)


def test_bench_case_on_the_cpu(bench, capsys):
    case = next(c for c in bench.CASES if c[0] == "Supervised-R18")
    name, meta, dn, pose, _, _, _, opts = case
    res = bench.bench_case(name, meta, dn, pose, 1, 64, 128, opts, device="cpu", warm_steps=1, chunks=1,
                           chunk_steps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "Supervised-R18: no warm start (encoder '18'): seeded weights"
    m = re.fullmatch(r"Supervised-R18\s+B=1\s+64x128:\s+([\d.]+) img/s/card", lines[-1])
    assert m and float(m.group(1)) == pytest.approx(res["images_per_s"], abs=0.051)
    assert res["steps"] == 2 and np.isfinite(res["last_loss"])


def test_trace_step_on_the_cpu(tmp_path, capsys):
    tool = _tool("trace_step")
    with pytest.raises(SystemExit, match="no counterpart in the port"):
        tool.main(["--no-adaptive", "--device", "cpu"])
    top = 6
    res = tool.main(["--device", "cpu", "--family", "Supervised", "--batch", "1", "--top", str(top),
                     "--outdir", str(tmp_path)], warm_steps=1, n_steps=1)
    out = capsys.readouterr().out.strip().splitlines()
    assert os.path.getsize(res["trace"]) > 0 and res["device_type"] == "cpu"
    start = next(i for i, line in enumerate(out) if line.startswith("ranked by self CPU time"))
    rows = out[start + 2:]
    assert 1 <= len(rows) - 1 <= top and rows[-1].split()[2] == "TOTAL"
    total = float(rows[-1].split()[0])
    assert total == pytest.approx(sum(r[0] for r in res["table"]), abs=2e-3)
    assert any(re.fullmatch(r"[\w/]+\.py:\d+", r.split()[-1]) for r in rows[:-1])
    sources = [r[3] for r in res["table"]]
    assert any(s.startswith(("models/", "ops/", "parallel/", "geometry/")) for s in sources)
    backward = [r for r in res["table"] if r[2] == "aten::convolution_backward"]
    assert backward and backward[0][3].startswith("models/")  # the forward's line, not the backward call's


def test_loader_tree_matches_the_jax_tool(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from simpledepthestimation_tpu.config import CfgNode as JaxCfgNode
    from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
    from simpledepthestimation_tpu.data import build_train_loader as jax_train_loader
    from simpledepthestimation_tpu_torch.data import build_train_loader
    from simpledepthestimation_tpu_torch.data.png import read_png

    from tools import bench_loader as jax_loader_tool

    tool = _tool("bench_loader")
    root, ref_root = str(tmp_path / "port"), str(tmp_path / "jax")
    split = tool.make_tree(root, n=8, H=128, W=416)
    jax_loader_tool.make_tree(ref_root, n=8, H=128, W=416)
    for dirpath, _, files in os.walk(ref_root):
        for f in files:
            ref = os.path.join(dirpath, f)
            with open(ref, "rb") as a, open(os.path.join(root, os.path.relpath(ref, ref_root)), "rb") as b:
                assert a.read() == b.read(), ref

    cfg = tool.loader_cfg(root, split, workers=2, batch=4)
    ref = get_cfg_jax()
    t = ref.DATASETS.TRAIN
    t.NAME, t.DATA_ROOT, t.DEPTH_ROOT, t.SPLIT, t.DEPTH_TYPE = "KittiDepthV2", os.path.join(root, "raw"), "", split, "none"
    t.FORWARD_CONTEXT = t.BACKWARD_CONTEXT = t.STRIDE = 1
    t.PREPROCESS = [JaxCfgNode({"NAME": "LoadImg", "WITH_CTX": True}),
                    JaxCfgNode({"NAME": "Resize", "IMG_W": 640, "IMG_H": 192}),
                    JaxCfgNode({"NAME": "RandomFlip"}), JaxCfgNode({"NAME": "RandomImageAug"}),
                    JaxCfgNode({"NAME": "ToTensor"})]
    ref.SOLVER.IMS_PER_BATCH, ref.DATALOADER.NUM_WORKERS = 4, 2
    assert cfg.to_dict() == ref.to_dict()

    port_batch = next(iter(build_train_loader(cfg, seed=0)))
    jax_batch = next(iter(jax_train_loader(ref, seed=0)))
    arrays = {k: v for k, v in jax_batch.items() if isinstance(v, np.ndarray)}
    assert {"img", "img_orig", "ctx_img", "ctx_img_orig", "intrinsics", "flip"} <= set(arrays)
    _assert_same_batch({k: port_batch[k] for k in arrays}, arrays)
    assert port_batch["img"].shape == (4, 3, 192, 640)

    read = tool.frame_read_ms(split, root, repeats=1)
    assert read["opencv_written_ms"] > 0 and read["port_written_ms"] > 0
    with open(split) as f:
        first = os.path.join(root, "raw", f.readline().strip())

    np.testing.assert_array_equal(read_png(os.path.join(root, "port_written.png")), read_png(first))
    np.testing.assert_array_equal(read_png(first)[..., ::-1], cv2.imread(first))


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_nothing_of_jax(name):
    """By the syntax tree: no import of ``jax``, of the JAX package, of
    ``__graft_entry__`` or of the JAX tool, anywhere in the twin (functions included)."""
    with open(os.path.join(REPO, "tools", f"{name}_torch.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module or "")
            imported |= {f"{node.module}.{a.name}" for a in node.names}
    forbidden = re.compile(r"^(jax|jaxlib|flax|optax|orbax|__graft_entry__|simpledepthestimation_tpu"
                           r"|tools\.(bench_models|profile_step|trace_step|bench_loader))(\.|$)")
    assert not [m for m in imported if forbidden.match(m)], imported


def test_twins_refuse_to_run_without_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    bench = _tool("bench_models")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--family", "Supervised"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool("profile_step").main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _tool("trace_step").main([])
