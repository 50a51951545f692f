"""The port's networks vs the JAX package on the CPU, on shared weights.

Weights are initialised by the JAX model, perturbed with numpy (norm scales,
biases, running statistics) and carried across by ``load_flax_variables``;
inputs are numpy arrays from a seed; float32 on both sides. Network outputs
agree to 1e-4 relative: dozens of float32 convolutions summed in another order.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.models.depth_nets import DepthResNet as JDepthResNet
from simpledepthestimation_tpu.models.pose_nets import PoseNet as JPoseNet
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.depth_nets import DepthResNet, flip_images, parse_encoder_version
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict, load_flax_variables
from simpledepthestimation_tpu_torch.models.pose_nets import PoseNet
from simpledepthestimation_tpu_torch.models import layers as tlayers
from simpledepthestimation_tpu_torch.models import norm_layers as tnorm

from torch_port_helpers import (
    batch_to_torch, init_jax_monodepth2, make_batch, monodepth2_cfgs, nchw, nhwc, randomize_variables,
    to_numpy_tree,
)

B, H, W = 2, 64, 128
RTOL = 1e-4


@pytest.fixture(scope="module")
def meta():
    cfg_j, cfg_t = monodepth2_cfgs()
    batch = make_batch(seed=0, B=B, H=H, W=W)
    _, variables = init_jax_monodepth2(cfg_j, batch)
    return cfg_j, cfg_t, variables


def _load_subnet(net, prefix, params, stats=None):
    sd = flax_to_state_dict({prefix: params}, {prefix: stats} if stats else None)
    sd = {k[len(prefix) + 1:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    res = net.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in res.missing_keys)
    return net


def _tree_equal(a, b, path=""):
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        if hasattr(a[k], "items"):
            _tree_equal(a[k], b[k], f"{path}{k}.")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=path + k)


def test_load_flax_variables_round_trip(meta):
    """Flax tree → port state_dict → the JAX package's own converter → the same tree."""
    _, cfg_t, variables = meta
    model = build_model(cfg_t, device="cpu")
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    cfg_j, _, _ = meta
    params, stats = convert_meta_arch(model.state_dict(), cfg_j)
    _tree_equal(to_numpy_tree(params), variables["params"])
    _tree_equal(to_numpy_tree(stats), variables["batch_stats"])


@pytest.mark.parametrize("fault", ["missing", "extra", "extra_leaf", "shape", "stats_missing"])
def test_load_flax_variables_is_strict(fault, meta):
    _, cfg_t, variables = meta
    model = build_model(cfg_t, device="cpu")
    params = copy.deepcopy(variables["params"])
    stats = copy.deepcopy(variables["batch_stats"])
    if fault == "missing":
        del params["pose_net"]["conv3"]
    elif fault == "extra":
        params["depth_net"]["decoder"]["upconv_9_0"] = params["depth_net"]["decoder"]["upconv_4_0"]
    elif fault == "extra_leaf":
        params["pose_net"]["pose_head"]["scale"] = np.ones(3, np.float32)
    elif fault == "shape":
        k = params["depth_net"]["encoder"]["conv1"]["kernel"]
        params["depth_net"]["encoder"]["conv1"]["kernel"] = k[:, :, :, :32]
    elif fault == "stats_missing":
        del stats["depth_net"]["encoder"]["layer2_0"]["bn1"]
    with pytest.raises(ValueError):
        load_flax_variables(model, params, stats)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("flip", [None, (True, False)], ids=["noflip", "flip"])
def test_depth_resnet_matches_jax(flip, train, meta, rng):
    _, _, variables = meta
    img = rng.randn(B, H, W, 3).astype(np.float32)
    jnet = JDepthResNet(num_layers=18, max_depth=80.0)
    v = {"params": variables["params"]["depth_net"], "batch_stats": variables["batch_stats"]["depth_net"]}
    jflip = None if flip is None else jnp.asarray(flip)
    if train:
        ref, _ = jnet.apply(v, jnp.asarray(img), flip=jflip, train=True, mutable=["batch_stats"])
    else:
        ref = jnet.apply(v, jnp.asarray(img), flip=jflip, train=False)
    tnet = _load_subnet(DepthResNet(18), "depth_net", v["params"], v["batch_stats"])
    with torch.no_grad():
        out = tnet(nchw(img), flip=None if flip is None else torch.tensor(flip), train=train)
    assert len(out) == len(ref) == 4
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == (B, 1, H >> i, W >> i) and o.dtype == torch.float32
        np.testing.assert_allclose(nhwc(o), np.asarray(r), rtol=RTOL, atol=0)


def test_depth_resnet_upsample_depth(meta, rng):
    _, _, variables = meta
    img = rng.randn(B, H, W, 3).astype(np.float32)
    v = {"params": variables["params"]["depth_net"], "batch_stats": variables["batch_stats"]["depth_net"]}
    ref = JDepthResNet(num_layers=18, upsample_depth=True).apply(v, jnp.asarray(img), train=False)
    tnet = _load_subnet(DepthResNet(18, upsample_depth=True), "depth_net", v["params"], v["batch_stats"])
    with torch.no_grad():
        out = tnet(nchw(img), train=False)
    for o, r in zip(out, ref):
        assert o.shape == (B, 1, H, W)
        np.testing.assert_allclose(nhwc(o), np.asarray(r), rtol=RTOL, atol=0)


def test_batchnorm_running_statistics_after_train_forward(meta, rng):
    """momentum 0.1 here == 0.9 in Flax. The running mean agrees; the running
    variance does NOT agree as it stands: PyTorch folds in the unbiased batch
    variance, Flax the biased one, so the update terms differ by exactly
    n/(n-1) with n = B·h·w values per channel. Asserted as that relation, not
    absorbed into a tolerance."""
    _, _, variables = meta
    img = rng.randn(B, H, W, 3).astype(np.float32)
    v = {"params": variables["params"]["depth_net"], "batch_stats": variables["batch_stats"]["depth_net"]}
    _, mutated = JDepthResNet(num_layers=18).apply(v, jnp.asarray(img), train=True, mutable=["batch_stats"])
    new_stats = to_numpy_tree(mutated["batch_stats"])["encoder"]
    tnet = _load_subnet(DepthResNet(18), "depth_net", v["params"], v["batch_stats"])
    with torch.no_grad():
        tnet(nchw(img), train=True)
    sd = tnet.state_dict()
    m = 0.1
    checked = 0
    for name, n in [("bn1", B * (H // 2) * (W // 2)), ("layer2_0.bn1", B * (H // 8) * (W // 8)),
                    ("layer4_1.bn2", B * (H // 32) * (W // 32))]:
        node_new, node_old = new_stats, v["batch_stats"]["encoder"]
        for part in name.split("."):
            node_new, node_old = node_new[part], node_old[part]
        key = "encoder.encoder." + name.replace("_", ".", 1) if name.startswith("layer") else "encoder.encoder." + name
        np.testing.assert_allclose(sd[key + ".running_mean"].numpy(), node_new["mean"], rtol=1e-4, atol=1e-5)
        flax_update = (node_new["var"] - (1 - m) * node_old["var"]) / m  # biased batch variance
        torch_update = (sd[key + ".running_var"].numpy() - (1 - m) * node_old["var"]) / m
        np.testing.assert_allclose(torch_update, flax_update * n / (n - 1), rtol=2e-4)
        if n <= 64:  # where n is small the two rules are visibly apart
            assert np.abs(torch_update / flax_update - 1).min() > 0.5 / n
        assert int(sd[key + ".num_batches_tracked"]) == 1
        checked += 1
    assert checked == 3
    # train=False leaves the statistics alone
    before = {k: t.clone() for k, t in tnet.state_dict().items()}
    with torch.no_grad():
        tnet(nchw(img), train=False)
    assert all(torch.equal(before[k], t) for k, t in tnet.state_dict().items())


def test_posenet_matches_jax(meta, rng):
    _, _, variables = meta
    x = rng.randn(B, H, W, 9).astype(np.float32)
    ref = JPoseNet(num_contexts=2).apply({"params": variables["params"]["pose_net"]}, jnp.asarray(x))
    tnet = _load_subnet(PoseNet(2), "pose_net", variables["params"]["pose_net"])
    with torch.no_grad():
        out = tnet(nchw(x), train=True)
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        assert o.shape == (B, 4, 4)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=1e-7)


def test_encoder_versions_and_param_names():
    assert parse_encoder_version("18pt") == (18, True)
    assert parse_encoder_version(50) == (50, False)
    with pytest.raises(ValueError):
        parse_encoder_version("101")
    keys = set(DepthResNet(50).state_dict())
    assert "encoder.encoder.layer1.0.conv3.weight" in keys
    assert "encoder.encoder.layer1.0.downsample.1.running_var" in keys
    assert "decoder.decoder.13.conv.weight" in keys and "decoder.decoder.0.conv.conv.bias" in keys
    x = torch.zeros(1, 3, 64, 128)
    with torch.no_grad():
        for n in (34, 50):
            assert [tuple(d.shape) for d in DepthResNet(n)(x)] == [(1, 1, 64 >> i, 128 >> i) for i in range(4)]


def test_small_layers(rng):
    from simpledepthestimation_tpu.models import layers as jlayers

    x = rng.rand(2, 5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(nhwc(tlayers.upsample_nearest_2x(nchw(x))),
                                  np.asarray(jlayers.upsample_nearest_2x(jnp.asarray(x))))
    sd_j, d_j = jlayers.disp_to_depth(jnp.asarray(x), 0.1, 80.0)
    sd_t, d_t = tlayers.disp_to_depth(nchw(x), 0.1, 80.0)
    np.testing.assert_allclose(nhwc(d_t), np.asarray(d_j), rtol=1e-6)
    np.testing.assert_allclose(nhwc(sd_t), np.asarray(sd_j), rtol=1e-6)
    flipped = flip_images(nchw(x), torch.tensor([True, False]))
    np.testing.assert_array_equal(nhwc(flipped)[0], x[0, :, ::-1])
    np.testing.assert_array_equal(nhwc(flipped)[1], x[1])
    gn = tnorm.GroupNorm(16, 32)
    assert gn(torch.rand(2, 32, 4, 4).bfloat16()).dtype == torch.float32


def test_compute_dtype_policy():
    """bfloat16 convolutions, float32 everywhere else; parameters stay float32."""
    _, cfg = monodepth2_cfgs(["TPU.COMPUTE_DTYPE", "bfloat16"])
    model = build_model(cfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    conv = model.depth_net.encoder.encoder.conv1
    assert conv.compute_dtype == torch.bfloat16
    x = torch.rand(1, 3, 64, 128)
    assert conv(x).dtype == torch.bfloat16
    assert model.depth_net.encoder.encoder.bn1(conv(x), False).dtype == torch.float32
    with torch.no_grad():
        feats = model.depth_net.encoder(x)
        depths = model.depth_net(x)
    assert all(f.dtype == torch.float32 for f in feats)
    assert all(d.dtype == torch.float32 for d in depths)
