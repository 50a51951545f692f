"""The rigid-only MotionLearning nets: the port vs the JAX package on the CPU.

``projects/MotionLearning/configs/resnet18.yaml`` with ``MODEL.DEPTH_NET.NAME
GoogleResNetv2`` and ``MODEL.POSE_NET.NAME GooglePoseNet`` (randLN, clip_ste
scales, RGB-D pose input) in float32 at B=2, 64x96, noise 0: the depth net, the
pose net, and the rigid branch of ``MotionLearningModel`` (the pose's
translation broadcast over the image, no motion losses, the cycle loss on the
broadcast translations).

Weights: the JAX package has no checkpoint converter for GoogleResNetv2, so its
Flax tree comes from a jitted ``init`` of the depth net alone (ResNet-18 sized,
a few seconds), perturbed with numpy and loaded into the port with
``load_flax_variables``; GooglePoseNet's comes from the port's seeded init
through the JAX package's ``convert_google_posenet``.

Measured on an 8-core CPU (2 torch threads), limits beside:
- GoogleResNetv2 depth per pixel relative: BN eval 1.4e-6, train 2.0e-6;
  randLN at noise 0, eval 2.1e-6, train 2.0e-6 (1e-5); the running statistics
  after the BN train pass 7.1e-7 of each tensor's largest (1e-5).
- MaxpoolShortcutBlock on an odd 8x25 plane (stride 2, 64 → 128 channels):
  4.7e-7 of the output's largest (1e-5).
- GooglePoseNet: the pose 6.0e-8 of its largest entry (1e-5); the gradient of
  a fixed linear function of it per tensor 9.3e-6 (``rot_scale``; 1e-4, plus a
  floor of 1e-6 of the largest gradient for conv1's bias under GroupNorm).
- The rigid MotionLearningModel: loss dict 3.5e-6 relative (``trans_loss``;
  1e-4); no pixel of the occlusion mask differs; the parameter gradient per
  tensor ``max|Δ| ≤ 1e-4·max|g|`` plus a floor of 1e-6 of the largest gradient
  of any tensor (``trans_scale``'s), ``test_torch_motionlearning.py``'s rule:
  median 2.0e-5 of a tensor's largest, worst 5.8e-4 at ``depth_net.conv1.weight``,
  whose largest is 1/350 of ``trans_scale``'s and lies within the floor (the
  cycle loss's ill-conditioning, which that test's docstring measures).
"""

import functools
import logging
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu.models import google_resnet as jax_google
from simpledepthestimation_tpu.models.pose_nets import GooglePoseNet as JaxGooglePoseNet
from simpledepthestimation_tpu.models.torch_import import convert_google_posenet
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import _google_encoder, flax_to_state_dict, load_flax_variables
from simpledepthestimation_tpu_torch.models.google_resnet import GoogleResNetv2, MaxpoolShortcutBlock
from simpledepthestimation_tpu_torch.models.pose_nets import GooglePoseNet
from simpledepthestimation_tpu_torch.models.pretrained import maybe_load_pretrained_encoder

from torch_port_helpers import REPO, batch_to_torch, nchw, nhwc, randomize_variables, smooth_field, to_numpy_tree

B, H, W = 2, 64, 96
CONFIG = os.path.join(REPO, "projects", "MotionLearning", "configs", "resnet18.yaml")
RIGID = ["MODEL.DEPTH_NET.NAME", "GoogleResNetv2", "MODEL.POSE_NET.NAME", "GooglePoseNet"]
LOSS_KEYS = {"rgb_l1_loss", "ssim_loss", "rot_loss", "trans_loss", "smooth_loss"}
# the limits and what they were set from: module docstring
DEPTH_RTOL, STATS_RTOL, POSE_RTOL, POSE_GRAD_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5, 1e-5, 1e-4, 1e-4, 1e-4


def _cfgs(extra=()):
    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list([*RIGID, "MODEL.DEPTH_NET.ENCODER_NAME", "18", "TPU.COMPUTE_DTYPE", "float32", *extra])
        out.append(cfg)
    return tuple(out)


def _holder(**nets):
    """An ``nn.Module`` holding ``nets`` under their names, so that
    ``load_flax_variables`` reads the meta-architecture's tree into them."""
    holder = nn.Module()
    for name, net in nets.items():
        setattr(holder, name, net)
    return holder


def _image(seed, h=H, w=W):
    return ((smooth_field(np.random.RandomState(seed), B, h, w, 3) - 0.45) / 0.225).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _v2_init(norm):
    """The JAX GoogleResNetv2 and its Flax tree from a jitted ``init``, once per norm."""
    net = jax_google.GoogleResNetv2(norm=norm)
    return net, to_numpy_tree(jax.jit(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))())


def _v2_variables(norm, seed=1):
    """A perturbed copy of :func:`_v2_init`'s tree."""
    net, variables = _v2_init(norm)
    return net, randomize_variables(variables, seed=seed)


@pytest.mark.parametrize("norm", ["BN", "randLN"])
def test_google_resnet_v2_matches_jax(norm):
    """The depth of one flipped and one plain sample in train mode (BN: and the
    running statistics after it; randLN at noise 0) and in eval mode."""
    net_j, variables = _v2_variables(norm)
    net = GoogleResNetv2(norm=norm)
    load_flax_variables(_holder(depth_net=net), {"depth_net": variables["params"]},
                        {"depth_net": variables.get("batch_stats", {})})
    img, flip = _image(2), np.array([False, True])
    gen = torch.Generator().manual_seed(0)

    def both(v, x, f):
        """Eval mode, then train mode from the same variables (one compile)."""
        rngs = {"noise": jax.random.PRNGKey(0)}
        return net_j.apply(v, x, f, train=False, rngs=rngs), net_j.apply(v, x, f, train=True, rngs=rngs,
                                                                         mutable=["batch_stats"])

    want_eval, (want_train, new_stats) = jax.jit(both)(variables, img, flip)
    for train, want in ((False, want_eval), (True, want_train)):  # eval first: train moves the port's statistics
        got = net(nchw(img), flip=torch.from_numpy(flip), train=train, noise_stddev=0.0, generator=gen)
        got, want = nhwc(got[0]), np.asarray(want[0])
        assert got.shape == want.shape == (B, H, W, 1)
        assert np.abs(got / want - 1).max() <= DEPTH_RTOL, (train, np.abs(got / want - 1).max())
    if norm == "BN":
        stats = flax_to_state_dict({"depth_net": variables["params"]},
                                   to_numpy_tree({"depth_net": new_stats["batch_stats"]}))
        own = net.state_dict()
        for k, v in stats.items():
            if k.endswith(("running_mean", "running_var")):
                key = k[len("depth_net."):]
                assert np.abs(own[key].numpy() - v).max() <= STATS_RTOL * np.abs(v).max(), key


def test_maxpool_shortcut_on_an_odd_plane_matches_jax():
    """At 64x200 layer3's first block sees 8x25: flax's ``"SAME"`` max pool pads
    the odd row and column with −inf at the end, the port's ``ceil_mode`` keeps
    them; then 64 channels are zero-padded to 128. BatchNorm in train mode."""
    block_j = jax_google.MaxpoolShortcutBlock(128, stride=2, norm="BN")
    x = np.random.RandomState(3).randn(2, 8, 25, 64).astype(np.float32)
    variables = randomize_variables(to_numpy_tree(jax.jit(lambda: block_j.init(jax.random.PRNGKey(1), x))()))
    want, _ = block_j.apply(variables, x, train=True, mutable=["batch_stats"])
    block = MaxpoolShortcutBlock(64, 128, stride=2, norm="BN")
    sd = {}
    _google_encoder(sd, "", {"layer1_0": variables["params"]}, {"layer1_0": variables["batch_stats"]})
    own = block.state_dict()
    assert {k[len("layer1.0."):] for k in sd} == {k for k in own if not k.endswith("num_batches_tracked")}
    block.load_state_dict({**own, **{k[len("layer1.0."):]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}})
    got = nhwc(block(nchw(x), train=True))
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 4, 13, 128)
    assert np.abs(got - want).max() <= DEPTH_RTOL * np.abs(want).max()


POSE_CASES = [("clip", False, True), ("clip_ste", False, True), ("softplus", True, True), ("clip", True, False)]


@pytest.mark.parametrize("constraint,group_norm,learn_scale", POSE_CASES)
def test_google_posenet_matches_jax(constraint, group_norm, learn_scale):
    """The pose of an RGB-D pair and the parameter gradient of a fixed linear
    function of it. ``rot_scale`` starts below the clip's minimum (0.001), where
    ``clip`` passes no gradient and ``clip_ste`` passes it straight through."""
    net = GooglePoseNet(in_channels=8, group_norm=group_norm, learn_scale=learn_scale, scale_constraint=constraint)
    from simpledepthestimation_tpu_torch.models.build import init_weights

    init_weights(net, torch.Generator().manual_seed(4))
    params = randomize_variables(to_numpy_tree(convert_google_posenet(net.state_dict())[0]), seed=5)
    if learn_scale:
        params["rot_scale"] = np.float32(0.0005)
        params["trans_scale"] = np.float32(0.02)
    load_flax_variables(_holder(pose_net=net), {"pose_net": params})
    net_j = JaxGooglePoseNet(group_norm=group_norm, learn_scale=learn_scale, scale_constraint=constraint)
    rng = np.random.RandomState(6)
    x = rng.rand(B, H, W, 8).astype(np.float32)
    weights = rng.randn(B, 4, 4).astype(np.float32)

    def f(p):
        pose = net_j.apply({"params": p}, x)
        return jnp.sum(pose * weights), pose

    (_, pose_j), grads_j = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    pose = net(nchw(x))
    (pose * torch.from_numpy(weights)).sum().backward()
    pose_j = np.asarray(pose_j)
    assert pose.shape == (B, 4, 4)
    assert np.abs(pose.detach().numpy() - pose_j).max() <= POSE_RTOL * np.abs(pose_j).max()
    want = flax_to_state_dict(to_numpy_tree({"pose_net": grads_j}))
    # with GROUP_NORM, conv1's bias feeds a GroupNorm of one channel per group, which removes
    # it: its gradient is rounding noise on both sides. Hence the floor, 1e-6 of the largest
    # gradient of any tensor.
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for name, p in net.named_parameters():
        w = want[f"pose_net.{name}"]
        assert np.abs(p.grad.numpy() - w).max() <= POSE_GRAD_RTOL * np.abs(w).max() + floor, name
    if learn_scale:
        rot_grad = float(net.rot_scale.grad)
        assert (rot_grad == 0.0) == (constraint == "clip"), rot_grad


def _motion_batch(seed=3):
    rng = np.random.RandomState(seed)
    img = smooth_field(rng, B, H, W, 3)
    ctx = (np.roll(img, 2, axis=2)[:, None] + 0.01 * rng.rand(B, 1, H, W, 3)).astype(np.float32)
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    return {"img": img, "ctx_img": ctx, "intrinsics": K, "flip": np.array([False, True]),
            "noise_stddev": np.float32(0.0), "motion_weight": np.float32(1.0)}


def test_rigid_motion_learning_losses_and_gradient_match_jax():
    """The rigid ``MotionLearningModel``: loss dict, occlusion mask and the whole
    parameter gradient from one jitted JAX function."""
    from simpledepthestimation_tpu_torch.models.motion_meta_arch import MotionLearningModel

    cfg_j, cfg_t = _cfgs()
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    _, v2 = _v2_variables("randLN", seed=7)
    pose = randomize_variables(to_numpy_tree(convert_google_posenet(
        {k[len("pose_net."):]: v for k, v in port.state_dict().items() if k.startswith("pose_net.")})[0]), seed=8)
    params = {"depth_net": v2["params"], "pose_net": pose}
    load_flax_variables(port, params)
    model_j = build_model_jax(cfg_j)
    batch = _motion_batch()

    def loss_fn(p, b):
        out, inter = model_j.apply({"params": p}, b, train=True, rngs={"noise": jax.random.PRNGKey(0)},
                                   capture_intermediates=lambda m, method: method == "_rgbd_consistency",
                                   mutable=["intermediates"])
        return sum(v for k, v in out.items() if "loss" in k), (out, inter["intermediates"])

    (loss_j, (out_j, inter_j)), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    seen = {}
    rgbd = MotionLearningModel._rgbd_consistency

    def spy(self, *args):
        out = rgbd(self, *args)
        seen["occlusion_mask"] = out["occlusion_mask"].detach()
        return out

    MotionLearningModel._rgbd_consistency = spy
    try:
        out = port(batch_to_torch(batch), train=True, generator=torch.Generator().manual_seed(0))
    finally:
        MotionLearningModel._rgbd_consistency = rgbd
    occ_j = np.asarray(inter_j["_rgbd_consistency"][0]["occlusion_mask"])
    assert int((nhwc(seen["occlusion_mask"]) != occ_j).sum()) == 0 and occ_j.mean() > 0.2
    assert set(out) == {k for k in out_j if "loss" in k} == LOSS_KEYS
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(out[k].detach()), float(out_j[k]), rtol=LOSS_RTOL, err_msg=k)
    total = sum(out.values())
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss_j), rtol=LOSS_RTOL)

    want = flax_to_state_dict(to_numpy_tree(grads_j))
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    bad = {}
    for name, p in port.named_parameters():
        g, w = p.grad.numpy(), want[name]
        assert np.abs(w).max() > 0, f"{name}: the JAX gradient is identically zero"
        err = np.abs(g - w).max()
        if not err <= GRAD_RTOL * np.abs(w).max() + floor:
            bad[name] = (float(err), float(np.abs(w).max()))
    assert not bad, bad
    # both scales of the pose net and the depth net's first convolution hang on the loss
    assert {"pose_net.rot_scale", "pose_net.trans_scale", "depth_net.conv1.weight"} <= set(want)


def test_warm_start_on_a_net_without_a_torchvision_encoder(tmp_path, caplog, monkeypatch):
    """``ENCODER_NAME 18pt`` on GoogleResNetv2 with a ResNet-18 weight file in
    reach: the JAX package warns of the layout mismatch and trains from its
    init; so does the port, and every weight stays as it was, to the bit."""
    # caplog listens at the root: an entry-point test earlier in the same worker leaves the port's logger
    # not propagating there (utils.logger.setup_logger)
    monkeypatch.setattr(logging.getLogger("simpledepthestimation_tpu_torch"), "propagate", True)
    from simpledepthestimation_tpu_torch.models.resnet import ResNetEncoder

    trunk = ResNetEncoder(18).encoder
    weights = tmp_path / "resnet18.pth"
    torch.save({**trunk.state_dict(), "fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000)}, weights)
    _, cfg_t = _cfgs(["MODEL.DEPTH_NET.ENCODER_NAME", "18pt", "MODEL.DEPTH_NET.PRETRAINED_WEIGHTS", str(weights)])
    model = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(9))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.WARNING, logger="simpledepthestimation_tpu_torch.models.pretrained"):
        found = maybe_load_pretrained_encoder(cfg_t, model)
    assert found is None
    assert any("layout mismatch" in r.getMessage() and "GoogleResNetv2" in r.getMessage() for r in caplog.records)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
