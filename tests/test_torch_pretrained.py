"""The ImageNet warm start of a ``pt`` encoder: the port vs the JAX package on the CPU.

The test writes a seeded torchvision-layout ResNet-18 ``state_dict`` (numpy
from a seed, with the ``fc.*`` head and the ``num_batches_tracked`` counters a
torchvision file holds) into a temporary directory; nothing is downloaded. A
seeded port model goes to the JAX side through the JAX package's own
``convert_meta_arch`` (no JAX ``init``), both packages load the file with their
``load_pretrained_encoder``, and ``flax_to_state_dict`` of the JAX result must
equal the port's ``state_dict`` exactly: the load is a copy (and a transpose on
the JAX side), so no value may move by a bit.
"""

import logging
import os

import numpy as np
import pytest
import torch

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.models import pretrained as jax_pretrained
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models import pretrained
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict
from simpledepthestimation_tpu_torch.parallel import create_train_state

from torch_port_helpers import REPO

MONODEPTH2 = os.path.join(REPO, "projects", "MonoDepth2", "configs", "resnet18.yaml")
MOTION = os.path.join(REPO, "projects", "MotionLearning", "configs", "resnet18.yaml")
LOGGER = "simpledepthestimation_tpu_torch.models.pretrained"


def _cfgs(path, extra=()):
    """The shipped yaml as it stands (``ENCODER_NAME "18pt"``) under both packages."""
    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(path)
        cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32", *extra])
        out.append(cfg)
    return tuple(out)


def _resnet18_state_dict(seed):
    """A torchvision ResNet-18 ``state_dict`` of seeded values: every conv,
    BN affine and running statistic, the ``fc`` head and the counters."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(key, cout, cin, k):
        sd[f"{key}.weight"] = (rng.randn(cout, cin, k, k) / np.sqrt(cin * k * k)).astype(np.float32)

    def bn(key, ch):
        sd[f"{key}.weight"] = (0.5 + rng.rand(ch)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.randn(ch)).astype(np.float32)
        sd[f"{key}.running_mean"] = (0.1 * rng.randn(ch)).astype(np.float32)
        sd[f"{key}.running_var"] = (0.5 + rng.rand(ch)).astype(np.float32)
        sd[f"{key}.num_batches_tracked"] = np.array(1000 + seed, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for b in range(2):
            p = f"layer{li}.{b}"
            conv(f"{p}.conv1", planes, cin if b == 0 else planes, 3)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            if b == 0 and cin != planes:
                conv(f"{p}.downsample.0", planes, cin, 1)
                bn(f"{p}.downsample.1", planes)
        cin = planes
    sd["fc.weight"] = rng.randn(1000, 512).astype(np.float32)
    sd["fc.bias"] = rng.randn(1000).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _write(directory, seed, name="resnet18.pth"):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(str(directory), name)
    torch.save(_resnet18_state_dict(seed), path)
    return path


def _port_state(model):
    return {k: v.clone() for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def _both_loaded(path, weights_file):
    """(JAX state_dict, port state_dict, port state before the load) after each
    package's ``load_pretrained_encoder`` of ``weights_file``."""
    cfg_j, cfg_t = _cfgs(path)
    model = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    seeded = _port_state(model)
    params, stats = convert_meta_arch(model.state_dict(), cfg_j)
    loaded = jax_pretrained.load_pretrained_encoder(
        {"params": params, "batch_stats": stats}, ("depth_net", "encoder"), 18, weights_file)
    pretrained.load_pretrained_encoder(model.depth_net.encoder, 18, weights_file)
    return flax_to_state_dict(loaded["params"], loaded["batch_stats"]), _port_state(model), seeded


def _assert_equal(jax_sd, port_sd):
    assert set(jax_sd) == set(port_sd)
    for k, v in port_sd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jax_sd[k]), err_msg=k)


def test_depth_resnet_loads_convs_bn_and_running_stats(tmp_path):
    weights = _write(tmp_path, seed=1)
    jax_sd, port_sd, seeded = _both_loaded(MONODEPTH2, weights)
    _assert_equal(jax_sd, port_sd)
    sd = torch.load(weights, weights_only=True)
    enc = "depth_net.encoder.encoder."
    for k in ("conv1.weight", "bn1.running_var", "layer2.0.downsample.1.running_mean", "layer4.1.bn2.bias"):
        assert torch.equal(port_sd[enc + k], sd[k]), k
    # the decoder and the pose net keep their seeded weights
    rest = [k for k in port_sd if not k.startswith(enc)]
    assert rest and all(torch.equal(port_sd[k], seeded[k]) for k in rest)


def test_google_resnet_randln_loads_conv_kernels_only(tmp_path):
    weights = _write(tmp_path, seed=2)
    jax_sd, port_sd, seeded = _both_loaded(MOTION, weights)
    _assert_equal(jax_sd, port_sd)
    sd = torch.load(weights, weights_only=True)
    enc = "depth_net.encoder.encoder."
    convs = [k for k in port_sd if k.startswith(enc) and port_sd[k].dim() == 4]
    assert len(convs) == 1 + 8 * 2 + 3  # conv1, two per basic block, three downsamples
    assert all(torch.equal(port_sd[k], sd[k[len(enc):]]) for k in convs)
    # the randLN norms (and everything outside the encoder's convs) keep their seeded values
    rest = [k for k in port_sd if k not in convs]
    assert any(".bn" in k for k in rest)
    assert all(torch.equal(port_sd[k], seeded[k]) for k in rest)


def test_missing_file_warns_and_keeps_seeded_weights(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("SDE_TPU_PRETRAINED_DIR", str(tmp_path))  # holds no resnet18.pth
    _, cfg = _cfgs(MONODEPTH2)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seeded = _port_state(model)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        assert pretrained.maybe_load_pretrained_encoder(cfg, model) is None
    assert any("No ImageNet weights found for encoder 18" in r.message for r in caplog.records)
    after = _port_state(model)
    assert all(torch.equal(after[k], seeded[k]) for k in seeded)


def test_layout_mismatch_warns_and_leaves_encoder_untouched(tmp_path, caplog):
    """A file that lacks one entry the encoder needs loads nothing (the JAX
    package's run-time wrapper skips such a file with the same warning)."""
    sd = _resnet18_state_dict(3)
    del sd["layer3.1.bn2.running_var"]
    weights = os.path.join(str(tmp_path), "broken.pth")
    torch.save(sd, weights)
    _, cfg = _cfgs(MONODEPTH2)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seeded = _port_state(model)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        pretrained.load_pretrained_encoder(model.depth_net.encoder, 18, weights)
    assert any("layout mismatch" in r.message and "layer3.1.bn2.running_var" in r.message
               for r in caplog.records)
    after = _port_state(model)
    assert all(torch.equal(after[k], seeded[k]) for k in seeded)


def test_explicit_weights_win_over_the_directory(tmp_path, monkeypatch):
    in_dir = _write(tmp_path / "dir", seed=4)
    explicit = _write(tmp_path / "explicit", seed=5, name="mine.pth")
    monkeypatch.setenv("SDE_TPU_PRETRAINED_DIR", str(tmp_path / "dir"))
    for find in (pretrained.find_pretrained_file, jax_pretrained.find_pretrained_file):
        assert find(18) == in_dir
        assert find(18, explicit) == explicit
        assert find(18, str(tmp_path / "absent.pth")) == in_dir
        assert find(50) is None
    _, cfg = _cfgs(MONODEPTH2, ["MODEL.DEPTH_NET.PRETRAINED_WEIGHTS", explicit])
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert pretrained.maybe_load_pretrained_encoder(cfg, model) == explicit
    want = torch.load(explicit, weights_only=True)["conv1.weight"]
    assert torch.equal(model.depth_net.encoder.encoder.conv1.weight.detach(), want)


@pytest.mark.parametrize("path", [MONODEPTH2, MOTION], ids=["MonoDepth2", "MotionLearning"])
def test_shipped_yaml_builds_a_train_state_with_the_warm_start(path, tmp_path, monkeypatch):
    """``create_train_state`` of the shipped yaml, unmodified ("18pt"), loads the
    encoder before the optimizer is made: the optimizer holds the loaded tensors."""
    weights = _write(tmp_path, seed=6)
    monkeypatch.setenv("SDE_TPU_PRETRAINED_DIR", str(tmp_path))
    _, cfg = _cfgs(path)
    assert str(cfg.MODEL.DEPTH_NET.ENCODER_NAME) == "18pt"
    state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert state.model.depth_net.pretrained and state.pretrained_weights == weights
    conv1 = state.model.depth_net.encoder.encoder.conv1.weight
    assert torch.equal(conv1.detach(), torch.load(weights, weights_only=True)["conv1.weight"])
    assert any(p is conv1 for group in state.optimizer.param_groups for p in group["params"])


def _bts_cfg(extra=()):
    """``projects/Supervised/configs/bts_r50.yaml`` (``resnet50_bts``) at ``BTS_SIZE`` 128, float32."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "projects", "Supervised", "configs", "bts_r50.yaml"))
    cfg.merge_from_list(["MODEL.DEPTH_NET.BTS_SIZE", "128", "TPU.COMPUTE_DTYPE", "float32", *extra])
    return cfg


def test_resnet50_bts_loads_from_a_local_file(tmp_path, monkeypatch):
    """``resnet50_bts`` reads ``$SDE_TPU_PRETRAINED_DIR/resnet50.pth`` (torchvision's
    names, with its ``fc`` head) in ``create_train_state``: the encoder holds the
    file's values, the decoder its seeded ones, and the optimizer the loaded
    tensors but for the ones BTS freezes."""
    cfg = _bts_cfg()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(8)
    sd = {k: torch.from_numpy(rng.rand(*v.shape).astype(np.float32)) if v.is_floating_point() else v
          for k, v in model.depth_net.encoder.encoder.state_dict().items()}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    torch.save(sd, str(tmp_path / "resnet50.pth"))
    monkeypatch.setenv("SDE_TPU_PRETRAINED_DIR", str(tmp_path))
    seeded = _port_state(model)
    state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert state.pretrained_weights == str(tmp_path / "resnet50.pth")
    after = _port_state(state.model)
    enc = "depth_net.encoder.encoder."
    assert all(torch.equal(after[k], sd[k[len(enc):]]) for k in after if k.startswith(enc))
    assert all(torch.equal(after[k], seeded[k]) for k in after if not k.startswith(enc))
    in_optimizer = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    trunk = state.model.depth_net.encoder.encoder
    assert id(trunk.layer1[0].conv1.weight) in in_optimizer and id(trunk.conv1.weight) not in in_optimizer


@pytest.mark.parametrize("case", ["missing-file", "name-outside-the-table"])
def test_bts_warm_start_warns_and_leaves_the_encoder_untouched(case, tmp_path, monkeypatch, caplog):
    """A ``*_bts`` name whose file is not in reach, or one that ``BTS_CONVERTIBLE``
    does not list, warns and loads nothing."""
    monkeypatch.setenv("SDE_TPU_PRETRAINED_DIR", str(tmp_path))  # holds no weight file
    cfg = _bts_cfg()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    seeded = _port_state(model)
    if case == "name-outside-the-table":
        cfg.MODEL.DEPTH_NET.ENCODER_NAME = "efficientnet_b0_bts"
        assert "efficientnet_b0_bts" not in pretrained.BTS_CONVERTIBLE
        message = "No pretrained conversion for BTS encoder efficientnet_b0_bts"
    else:
        message = "No ImageNet weights found for encoder 50"
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        assert pretrained.maybe_load_pretrained_encoder(cfg, model) is None
    assert any(message in r.message for r in caplog.records), [r.message for r in caplog.records]
    after = _port_state(model)
    assert all(torch.equal(after[k], seeded[k]) for k in seeded)
