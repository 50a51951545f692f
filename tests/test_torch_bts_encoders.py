"""The BTS encoder zoo and its ImageNet warm start: the port vs the JAX package on the CPU.

- ``resnext50_bts``, ``densenet121_bts``, ``mobilenetv2_bts``: the five feature
  maps at 2x3x128x192 in eval and in train mode, and the running statistics
  after the train-mode pass, against the JAX package's encoders (float32, one
  jitted function per encoder). Weights: the port's seeded init, carried to
  the JAX tree by the JAX package's torchvision converters (the port's trunk
  has torchvision's names), perturbed with numpy, loaded back with
  ``flax_import``. Limits per tensor, ``max|Δ| / max|x|``, measured on an
  8-core Intel Xeon CPU in brackets: eval 1e-5 [9.3e-7]; train 1e-3 [3.6e-4, the H/32
  tap of ResNeXt-50]; statistics 1e-4 [2.6e-5]. Train mode normalises each
  channel by its batch statistics over few values at the deep taps (48 at
  H/32), and sixteen such blocks in a row amplify float32's last bits; at
  1x3x64x96 (6 values a channel at H/32) the same tap was 1.2e-3 apart.
- ``resnext101_bts``, ``densenet161_bts``: the port alone (no JAX compile):
  build, the shapes of the taps, and the round trip port ``state_dict`` →
  the JAX package's converter → ``flax_import`` → equal ``state_dict``.
- The warm start: a seeded ``state_dict`` with torchvision's key names (the
  classifier and ``num_batches_tracked`` counters included) for resnet50,
  resnext50_32x4d, densenet121 and mobilenet_v2, written to ``tmp_path``, loads
  into the port equal to the bit to what the JAX package's
  ``load_pretrained_encoder`` puts in the Flax tree, mapped through ``flax_import``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.models import pretrained as jax_pretrained
from simpledepthestimation_tpu.models.encoders import BTS_ENCODERS as JAX_BTS_ENCODERS
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models import pretrained
from simpledepthestimation_tpu_torch.models.build import init_weights
from simpledepthestimation_tpu_torch.models.encoders import BTS_ENCODERS
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict

from torch_port_helpers import nchw, nhwc, randomize_variables, reference_state_dict, supervised_cfgs, to_numpy_tree

EVAL_RTOL, TRAIN_RTOL, STATS_RTOL = 1e-5, 1e-3, 1e-4  # measured: module docstring
CONVERTERS = {
    "resnext50_bts": lambda sd: jax_pretrained.convert_torch_resnet(sd, 50),
    "resnext101_bts": lambda sd: jax_pretrained.convert_torch_resnet(sd, 101),
    "densenet121_bts": lambda sd: jax_pretrained.convert_torch_densenet(sd, (6, 12, 24, 16)),
    "densenet161_bts": lambda sd: jax_pretrained.convert_torch_densenet(sd, (6, 12, 36, 24)),
    "mobilenetv2_bts": jax_pretrained.convert_torch_mobilenetv2,
}
STRIDES = (2, 4, 8, 16, 32)
SHAPE = (2, 128, 192, 3)


def _trunk_sd(encoder):
    """The port encoder's torchvision-named entries (what a torchvision file holds)."""
    return {k: v.numpy() for k, v in encoder.encoder.state_dict().items() if not k.endswith("num_batches_tracked")}


def _to_port(params, stats):
    """An encoder's Flax trees → the port encoder's ``state_dict`` entries (``encoder.…``)."""
    sd = flax_to_state_dict({"depth_net": {"encoder": params}}, {"depth_net": {"encoder": stats}})
    return {k[len("depth_net.encoder."):]: v for k, v in sd.items()}


def _load(encoder, sd):
    own = encoder.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(torch.from_numpy(np.array(v)))


@pytest.mark.parametrize("name", ["resnext50_bts", "densenet121_bts", "mobilenetv2_bts"])
def test_encoder_features_match_jax(name):
    encoder = BTS_ENCODERS[name][0](torch.float32)
    init_weights(encoder, torch.Generator().manual_seed(0))
    params, stats = CONVERTERS[name](_trunk_sd(encoder))
    variables = randomize_variables(to_numpy_tree({"params": params, "batch_stats": stats}), seed=2)
    _load(encoder, _to_port(variables["params"], variables["batch_stats"]))
    x = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    model_j = JAX_BTS_ENCODERS[name][0](jnp.float32, "encoder")

    def jax_fn(v, x):
        train, new = model_j.apply(v, x, train=True, mutable=["batch_stats"])
        return model_j.apply(v, x, train=False), train, new["batch_stats"]

    ref_eval, ref_train, ref_stats = jax.jit(jax_fn)(variables, jnp.asarray(x))
    with torch.no_grad():
        got_eval = encoder(nchw(x), train=False)
        got_train = encoder(nchw(x), train=True)
    channels = BTS_ENCODERS[name][1]
    for got, ref, limit in ((got_eval, ref_eval, EVAL_RTOL), (got_train, ref_train, TRAIN_RTOL)):
        assert [tuple(f.shape) for f in got] == [(SHAPE[0], c, SHAPE[1] // s, SHAPE[2] // s)
                                                 for c, s in zip(channels, STRIDES)]
        for i, (g, r) in enumerate(zip(got, ref)):
            r = np.asarray(r)
            assert np.abs(nhwc(g) - r).max() <= limit * np.abs(r).max(), (name, i)
    want = _to_port(variables["params"], to_numpy_tree(ref_stats))
    for k, v in encoder.state_dict().items():
        if "running" in k:
            assert np.abs(v.numpy() - want[k]).max() <= STATS_RTOL * np.abs(want[k]).max(), k


@pytest.mark.parametrize("name", ["resnext101_bts", "densenet161_bts"])
def test_large_encoders_build_and_round_trip(name):
    """The port alone: no JAX compile."""
    ctor, channels = BTS_ENCODERS[name]
    encoder = ctor(torch.float32)
    init_weights(encoder, torch.Generator().manual_seed(1))
    with torch.no_grad():
        feats = encoder(torch.rand(1, 3, 64, 96), train=False)
    assert [tuple(f.shape) for f in feats] == [(1, c, 64 // s, 96 // s) for c, s in zip(channels, STRIDES)]
    sd = _trunk_sd(encoder)
    back = _to_port(*CONVERTERS[name](sd))
    own = {k: v.numpy() for k, v in encoder.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(own)
    assert all(np.array_equal(back[k], own[k]) for k in own)
    if name == "resnext101_bts":  # 32 groups of width 8 in torchvision's resnext101_32x8d
        conv2 = encoder.encoder.layer1[0].conv2
        assert conv2.groups == 32 and conv2.weight.shape == (256, 8, 3, 3)


# --- the warm start ---

TORCHVISION = {  # BTS encoder name -> (file stem, classifier entries of the torchvision file)
    "resnet50_bts": ("resnet50", {"fc.weight": (1000, 2048), "fc.bias": (1000,)}),
    "resnext50_bts": ("resnext50_32x4d", {"fc.weight": (1000, 2048), "fc.bias": (1000,)}),
    "densenet121_bts": ("densenet121", {"classifier.weight": (1000, 1024), "classifier.bias": (1000,)}),
    "mobilenetv2_bts": ("mobilenet_v2", {"classifier.1.weight": (1000, 1280), "classifier.1.bias": (1000,)}),
}


def torchvision_state_dict(encoder, extra, seed):
    """Seeded values under torchvision's key names: the trunk's entries (which
    the JAX package's converters read by those names), the classifier and a
    ``num_batches_tracked`` counter for every BatchNorm."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in encoder.encoder.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000 + seed)
        elif k.endswith(("running_var", "weight")) and v.dim() == 1:
            sd[k] = torch.from_numpy((0.5 + rng.rand(*v.shape)).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((0.1 * rng.randn(*v.shape)).astype(np.float32))
    for k, shape in extra.items():
        sd[k] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return sd


@pytest.mark.parametrize("name", sorted(TORCHVISION))
def test_bts_warm_start_equals_jax_to_the_bit(name, tmp_path, monkeypatch):
    stem, extra = TORCHVISION[name]
    cfg_j, cfg_t = supervised_cfgs("bts_r50.yaml", ["MODEL.DEPTH_NET.ENCODER_NAME", name,
                                                    "MODEL.DEPTH_NET.BTS_SIZE", "128", "TPU.COMPUTE_DTYPE", "float32"])
    model = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    weights = tmp_path / f"{stem}.pth"
    torch.save(torchvision_state_dict(model.depth_net.encoder, extra, seed=7), weights)
    monkeypatch.setenv("SDE_TPU_PRETRAINED_DIR", str(tmp_path))

    sd = {k: v.clone() for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    params, stats = convert_meta_arch(reference_state_dict(sd, cfg_j), cfg_j)
    filename, arch = jax_pretrained.BTS_CONVERTIBLE[name]
    assert (filename, arch) == pretrained.BTS_CONVERTIBLE[name] and filename == stem
    loaded = jax_pretrained.load_pretrained_encoder(
        {"params": params, "batch_stats": stats}, ("depth_net", "encoder"), arch, str(weights))
    want = flax_to_state_dict(to_numpy_tree(loaded["params"]), to_numpy_tree(loaded["batch_stats"]))

    assert pretrained.maybe_load_pretrained_encoder(cfg_t, model) == str(weights)
    got = {k: v.numpy() for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    changed = [k for k in got if k.startswith("depth_net.encoder.") and not np.array_equal(got[k], sd[k].numpy())]
    assert len(changed) == sum(k.startswith("depth_net.encoder.") for k in got)  # the whole encoder loaded
    assert all(np.array_equal(got[k], want[k]) for k in got), [k for k in got if not np.array_equal(got[k], want[k])][:5]
