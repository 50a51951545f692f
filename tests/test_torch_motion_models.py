"""The MotionLearning modules of the port vs the JAX package on the CPU.

RandLayerNorm (with the JAX module's own normals regenerated here), the
GoogleResNet-18 depth net under randLN and BN (and the bottleneck ResNet-50), the GoogleMotionNet pose and
motion outputs under every scale constraint, the motion losses (values and
gradients), and the sizes-of-1 resize of the motion refiners. Same numpy
inputs and weights on both sides (``load_flax_variables``), float32.

Tolerances: 1e-5 relative for a single module's output (one float32 pass of
the same formula in another order); nets 1e-4 relative to the largest value
(a ResNet-18 or the 7-level motion trunk in float32, another convolution
algorithm); losses 1e-5 relative, their gradients 1e-5 of the largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.geometry import camera as jcam
from simpledepthestimation_tpu.models import losses as jl
from simpledepthestimation_tpu.models.google_resnet import GoogleResNet as JGoogleResNet
from simpledepthestimation_tpu.models.layers import RandLayerNorm as JRandLayerNorm
from simpledepthestimation_tpu.models.pose_nets import GoogleMotionNet as JGoogleMotionNet
from simpledepthestimation_tpu.models.pose_nets import _constrained_scale as j_constrained_scale
from simpledepthestimation_tpu.models.torch_import import convert_google_motion_net, convert_google_resnet
from simpledepthestimation_tpu_torch.geometry.camera import resize_img
from simpledepthestimation_tpu_torch.models import losses as tl
from simpledepthestimation_tpu_torch.models.build import init_weights
from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables
from simpledepthestimation_tpu_torch.models.google_resnet import GoogleResNet
from simpledepthestimation_tpu_torch.models.layers import ConvGNReLU, RandLayerNorm, rand_layer_norm
from simpledepthestimation_tpu_torch.models.pose_nets import GoogleMotionNet, _constrained_scale

from torch_port_helpers import nchw, nhwc, randomize_variables, smooth_field, to_numpy_tree

B, H, W = 2, 64, 96


def _holder(**nets):
    """A module with the meta-architecture's attribute names, so that the
    Flax trees load under ``depth_net`` / ``pose_net``."""
    holder = torch.nn.Module()
    for name, net in nets.items():
        setattr(holder, name, net)
    return holder


# --- RandLayerNorm --------------------------------------------------------------------------


@pytest.mark.parametrize("stddev", [0.0, 0.5])
def test_rand_layer_norm_matches_jax_with_its_own_normals(stddev, rng):
    x = (rng.randn(2, 5, 7, 6) * 2 + 1).astype(np.float32)
    scale = (0.5 + rng.rand(6)).astype(np.float32)
    bias = (0.1 * rng.randn(6)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    module = JRandLayerNorm()

    def jfn(xx, s, b):
        return module.apply({"params": {"scale": s, "bias": b}}, xx, stddev=jnp.float32(stddev), rng=key, train=True)

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    # the module's own draws: fold_in(rng, 0) for the mean, fold_in(rng, 1) for the variance
    noise = [nchw(np.asarray(jax.random.normal(jax.random.fold_in(key, i), (2, 1, 1, 6), jnp.float32)))
             for i in (0, 1)]
    tx = nchw(x).requires_grad_()
    ts, tb = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    got = rand_layer_norm(tx, ts, tb, torch.tensor(stddev), noise[0], noise[1], eps=1e-3)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    ct = rng.randn(*x.shape).astype(np.float32)
    g_x, g_s, g_b = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    got.backward(nchw(ct))
    np.testing.assert_allclose(nhwc(tx.grad), g_x, rtol=1e-5, atol=1e-5)  # statistics detached
    np.testing.assert_allclose(ts.grad.numpy(), g_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), g_b, rtol=1e-5, atol=1e-5)
    if stddev == 0.0:  # fmod(0, tiny) = 0: the noise has no effect, and eval equals train
        want_eval = module.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                                 jnp.asarray(x), train=False)
        np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want_eval), rtol=1e-6, atol=1e-6)


def test_rand_layer_norm_bfloat16_follows_the_jax_dtype_rule(rng):
    """bfloat16 input: statistics in bfloat16, noise in bfloat16 promoted to
    float32 by the float32 stddev, float32 out (JAX: ``layers.py`` RandLayerNorm).
    One bfloat16 rounding of a statistic moves the output by up to 2^-8 of its
    size; 2^-6 relative to the largest value holds that with margin."""
    x = (rng.randn(2, 6, 8, 4) * 2 + 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    p = {"scale": jnp.ones(4), "bias": jnp.zeros(4)}
    want = JRandLayerNorm().apply({"params": p}, xb, stddev=jnp.float32(0.5), rng=key, train=True)
    assert want.dtype == jnp.float32
    noise = [nchw(np.asarray(jax.random.normal(jax.random.fold_in(key, i), (2, 1, 1, 4), jnp.bfloat16)
                             .astype(jnp.float32))).bfloat16() for i in (0, 1)]
    got = rand_layer_norm(nchw(x).bfloat16(), torch.ones(4), torch.zeros(4), torch.tensor(0.5), *noise)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2.0**-6 * np.abs(np.asarray(want)).max(), rtol=0)


def test_rand_layer_norm_module_draws_only_in_training_from_its_generator(rng):
    x = nchw((rng.randn(2, 5, 7, 6)).astype(np.float32))
    norm = RandLayerNorm(6)
    plain = rand_layer_norm(x, norm.weight, norm.bias)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    torch.manual_seed(123)
    global_state = torch.get_rng_state()
    assert torch.equal(norm(x, train=False, stddev=0.5, generator=g), plain)
    assert torch.equal(norm(x, train=True, stddev=0.5), plain)  # no generator: no noise
    assert torch.equal(g.get_state(), state)
    noisy = norm(x, train=True, stddev=0.5, generator=g)
    assert not torch.allclose(noisy, plain)
    # the mean's normals first, then the variance's, from the given generator only
    g2 = torch.Generator().manual_seed(0)
    nm, nv = torch.randn(2, 6, 1, 1, generator=g2), torch.randn(2, 6, 1, 1, generator=g2)
    assert torch.equal(noisy, rand_layer_norm(x, norm.weight, norm.bias, 0.5, nm, nv))
    assert torch.equal(torch.get_rng_state(), global_state)
    # stddev 0 (the start of the ramp): noise drawn, no effect
    assert torch.equal(norm(x, train=True, stddev=torch.tensor(0.0), generator=g), plain)


# --- nets -----------------------------------------------------------------------------------


def _images(seed):
    rng = np.random.RandomState(seed)
    return ((smooth_field(rng, B, H, W, 3) - 0.45) / 0.225).astype(np.float32)


@pytest.mark.parametrize("norm,num_layers", [("randLN", 18), ("BN", 18), ("BN", 50)])
def test_google_resnet_forward_matches_jax(norm, num_layers):
    image = _images(0)
    flip = np.array([False, True])
    jnet = JGoogleResNet(num_layers=num_layers, norm=norm, dtype=jnp.float32)
    # the weights: the port's seeded init, through the JAX package's own converter,
    # perturbed, and loaded back (both directions of the naming)
    net = GoogleResNet(num_layers, norm=norm)
    init_weights(net, torch.Generator().manual_seed(0))
    params, stats = convert_google_resnet(net.state_dict(), num_layers, norm)
    variables = randomize_variables(to_numpy_tree({"params": params, "batch_stats": stats}))
    params, stats = variables["params"], variables["batch_stats"]
    assert ("rln" in params["encoder"]["n1"]) == (norm == "randLN") and bool(stats) == (norm == "BN")
    load_flax_variables(_holder(depth_net=net), {"depth_net": params}, {"depth_net": stats} if stats else None)
    gen = torch.Generator().manual_seed(0)
    for train in (False, True):
        jv = {"params": params, **({"batch_stats": stats} if stats else {})}
        out = jax.jit(lambda v, im, fl: jnet.apply(
            v, im, flip=fl, train=train, noise_stddev=jnp.float32(0.0), rngs={"noise": jax.random.PRNGKey(1)},
            mutable=["batch_stats"] if train else False))(jv, jnp.asarray(image), jnp.asarray(flip))
        want, new_stats = (out if train else (out, None))
        got = net(nchw(image), flip=torch.from_numpy(flip), train=train, noise_stddev=0.0, generator=gen)
        assert len(got) == 1 and got[0].shape == (B, 1, H, W) and got[0].dtype == torch.float32
        ref = np.asarray(want[0])
        np.testing.assert_allclose(nhwc(got[0].detach()), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
        if train and norm == "BN":  # the running statistics follow Flax's rule
            sd = net.state_dict()
            for k, v in to_numpy_tree(new_stats["batch_stats"])["encoder"]["layer3_1"]["n2"]["bn"].items():
                t = sd[f"encoder.encoder.layer3.1.bn2.running_{k}"].numpy()  # in both depths
                np.testing.assert_allclose(t, v, rtol=1e-4, atol=1e-6)
    # the noise is applied at stddev > 0, reproducibly from the generator
    noisy = [net(nchw(image), train=True, noise_stddev=0.5, generator=torch.Generator().manual_seed(7))[0]
             for _ in range(2)]
    if norm == "randLN":
        assert torch.equal(noisy[0], noisy[1])
        assert not torch.allclose(noisy[0], net(nchw(image), train=True, noise_stddev=0.0)[0])


@pytest.mark.parametrize("constraint,group_norm", [("clip", False), ("clip_ste", False), ("softplus", False),
                                                   ("clip_ste", True)])
def test_google_motion_net_matches_jax(constraint, group_norm, rng):
    x = np.concatenate([_images(1), rng.rand(B, H, W, 1).astype(np.float32) * 20,
                        _images(2), rng.rand(B, H, W, 1).astype(np.float32) * 20], -1)
    jnet = JGoogleMotionNet(group_norm=group_norm, learn_scale=True, mask_motion=True,
                            scale_constraint=constraint, dtype=jnp.float32)
    net = GoogleMotionNet(in_channels=8, group_norm=group_norm, scale_constraint=constraint)
    init_weights(net, torch.Generator().manual_seed(0))
    params = randomize_variables(to_numpy_tree(convert_google_motion_net(net.state_dict())[0]))
    # a rotation scale below the floor of the clips, so that the constraint acts
    params["trans_scale"] = np.float32(0.02)
    params["rot_scale"] = np.float32(-0.3)
    pose_j, motion_j = jax.jit(lambda p, xx: jnet.apply({"params": p}, xx, motion_weight=jnp.float32(0.5),
                                                        train=True))(params, jnp.asarray(x))
    load_flax_variables(_holder(pose_net=net), {"pose_net": params})
    pose, motion = net(nchw(x), motion_weight=torch.tensor(0.5), train=True)
    assert pose.shape == (B, 4, 4) and motion.shape == (B, 3, H, W)
    np.testing.assert_allclose(pose.detach().numpy(), np.asarray(pose_j), rtol=1e-4, atol=1e-6)
    ref = np.asarray(motion_j)
    np.testing.assert_allclose(nhwc(motion.detach()), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    kept = np.abs(ref).sum(-1) > 0
    assert 0 < kept.mean() < 1  # mask_motion kept some pixels and not all


@pytest.mark.parametrize("constraint", ["clip", "clip_ste", "softplus"])
def test_constrained_scale_value_and_gradient(constraint):
    raw = np.array([-0.3, 0.0005, 0.01, 0.4], np.float32)
    want, vjp = jax.vjp(lambda r: j_constrained_scale(r, constraint), jnp.asarray(raw))
    t = torch.from_numpy(raw).requires_grad_()
    got = _constrained_scale(t, constraint)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=0)
    got.sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.ones(4))[0]), rtol=1e-6, atol=0)
    if constraint == "clip_ste":  # clipped forward, gradient straight through
        assert float(got[0]) == pytest.approx(1e-3, rel=1e-4) and float(t.grad[0]) == 1.0


def test_conv_gn_relu_flag_and_init():
    with_gn, without = ConvGNReLU(8, 16, 3, 2), ConvGNReLU(8, 16, 3, 2, group_norm=False)
    assert isinstance(with_gn[1], torch.nn.GroupNorm) and isinstance(without[1], torch.nn.ReLU)
    assert with_gn[0].weight.shape == without[0].weight.shape == (16, 8, 3, 3)
    for constraint, value in (("clip_ste", 0.01), ("softplus", 0.4)):
        net = GoogleMotionNet(scale_constraint=constraint)
        net.trans_scale.data.fill_(7.0)
        init_weights(net, torch.Generator().manual_seed(0))
        assert float(net.trans_scale) == float(net.rot_scale) == pytest.approx(value)
        w = net.refiner3.conv3.weight  # Xavier-uniform: bound sqrt(6 / (fan_in + fan_out))
        bound = (6.0 / (w.shape[1] + w.shape[0])) ** 0.5
        assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.8 * bound
        assert net.conv8.bias.abs().max() == 0 and net.pose_pred.bias is None
    depth = GoogleResNet(18, norm="randLN")
    depth.encoder.encoder.bn1.weight.data.fill_(3.0)
    init_weights(depth, torch.Generator().manual_seed(0))
    assert torch.equal(depth.encoder.encoder.bn1.weight, torch.ones(64))
    w = depth.decoder.blocks[0].upconv.weight
    assert float(w.abs().max()) <= (6.0 / (9 * (w.shape[0] + w.shape[1]))) ** 0.5


@pytest.mark.parametrize("src,dst", [((1, 1), (1, 4)), ((1, 4), (2, 7)), ((2, 7), (4, 13)), ((1, 1), (3, 1)),
                                     ((4, 13), (1, 1))])
def test_resize_img_to_and_from_size_one(src, dst, rng):
    """The refiners resize the 1×1 seed to 1×4, then 2×7, ... (128×416 trunk):
    a one-point linspace gives 0 on both sides."""
    img = rng.randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jcam.resize_img(jnp.asarray(img), dst, mode="bilinear"))
    got = resize_img(nchw(img), dst, mode="bilinear")
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)


# --- motion losses --------------------------------------------------------------------------


def _grads_match(jfn, tfn, arrays, rtol=1e-5, skip_zeros=False, grad_rtol=1e-5):
    """Value and gradient w.r.t. every NHWC array of ``jfn`` (JAX) and ``tfn``
    (port, NCHW for 4-d arrays). ``skip_zeros``: at entries that are exactly
    0 the gradient of ``abs`` is 0 in PyTorch and 1 in JAX; there the port's
    gradient is held to its own convention instead."""
    want, vjp = jax.vjp(jax.jit(jfn), *[jnp.asarray(a) for a in arrays])
    want = want if isinstance(want, tuple) else (want,)
    leaves = [(nchw(a) if a.ndim == 4 else torch.from_numpy(a.copy())).requires_grad_() for a in arrays]
    got = tfn(*leaves)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=0)
    cts = [np.float32(1.0 + i) for i in range(len(want))]
    jg = vjp(tuple(jnp.asarray(c) for c in cts) if len(want) > 1 else jnp.asarray(cts[0]))
    tg = torch.autograd.grad(sum(c * g for c, g in zip(cts, got)), leaves, allow_unused=True)
    for a, j, t in zip(arrays, jg, tg):
        j = np.asarray(j)
        t = np.zeros_like(j) if t is None else (nhwc(t) if a.ndim == 4 else t.numpy())
        assert np.isfinite(t).all()
        if skip_zeros:
            zero = np.asarray(a) == 0
            assert np.all(t[zero] == 0)
            t, j = t[~zero], j[~zero]
        np.testing.assert_allclose(t, j, rtol=0, atol=grad_rtol * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("C1,C2", [(float("inf"), 9e-6), (1e-4, float("inf")), (1e-4, 9e-4)])
def test_weighted_ssim_matches_jax(C1, C2, rng):
    x = smooth_field(rng, 2, 16, 24, 3)
    y = (0.8 * x + 0.2 * rng.rand(2, 16, 24, 3)).astype(np.float32)
    w = rng.rand(2, 16, 24, 1).astype(np.float32)
    # gradients in the two images (the weights are detached where the model uses
    # them) to 1e-4 of the largest: the window variances cancel and are divided by
    # denominators down to C2 (9e-6 here), as in the photometric VJP
    _grads_match(lambda a, b: jl.weighted_ssim(a, b, jnp.asarray(w), C1, C2)[0].mean(),
                 lambda a, b: tl.weighted_ssim(a, b, nchw(w), C1, C2)[0].mean(), [x, y], grad_rtol=1e-4)
    d_j, avg_j = jl.weighted_ssim(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), C1, C2)
    d_t, avg_t = tl.weighted_ssim(nchw(x), nchw(y), nchw(w), C1, C2)
    np.testing.assert_allclose(nhwc(d_t), np.asarray(d_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(nhwc(avg_t), np.asarray(avg_j), rtol=1e-6, atol=1e-7)


def _rot(rng, n, scale):
    from simpledepthestimation_tpu_torch.geometry.pose import pose_vec2mat

    vec = np.concatenate([np.zeros((n, 3)), scale * rng.randn(n, 3)], 1).astype(np.float32)
    return pose_vec2mat(torch.from_numpy(vec))[:, :3, :3].numpy()


def test_motion_consistency_loss_matches_jax(rng):
    Bn, h, w = 2, 12, 20
    coords = (rng.rand(Bn, h, w, 2) * 2.4 - 1.2).astype(np.float32)  # some outside
    mask = (rng.rand(Bn, h, w, 1) > 0.3).astype(np.float32)
    R1, R2 = _rot(rng, Bn, 0.05), _rot(rng, Bn, 0.05)
    t1 = (0.1 * rng.randn(Bn, h, w, 3)).astype(np.float32)
    t2 = (0.1 * rng.randn(Bn, h, w, 3)).astype(np.float32)
    _grads_match(lambda c, m, a, b, u, v: jl.motion_consistency_loss(c, m, a, b, u, v),
                 lambda c, m, a, b, u, v: tl.motion_consistency_loss(c.permute(0, 2, 3, 1), m, a, b, u, v),
                 [coords, mask, R1, R2, t1, t2], rtol=1e-5)


def test_motion_consistency_coordinates_get_no_gradient(rng):
    coords = torch.from_numpy((rng.rand(1, 6, 8, 2) * 2 - 1).astype(np.float32)).requires_grad_()
    t = torch.from_numpy(rng.randn(1, 3, 6, 8).astype(np.float32)).requires_grad_()
    R = torch.eye(3)[None]
    rot, trans = tl.motion_consistency_loss(coords, torch.ones(1, 1, 6, 8), R, R, t, t)
    (trans + rot).backward()
    assert coords.grad is None and t.grad is not None and torch.isfinite(t.grad).all()


@pytest.mark.parametrize("zero", [False, True], ids=["motion", "zero-motion"])
def test_motion_smoothness_and_sparsity_match_jax(zero, rng):
    m = (0.0 if zero else 1.0) * rng.randn(2, 10, 14, 3).astype(np.float32)
    if not zero:
        m[:, 3:6] = 0.0  # zeros inside a moving field
    _grads_match(jl.motion_smoothness_loss, tl.motion_smoothness_loss, [m.astype(np.float32)])
    # the motion net's mask zeroes pixels: abs'(0) is PyTorch's 0 there (a gradient
    # the mask then cuts on both sides; ROADMAP.md § C)
    _grads_match(jl.motion_sparsity_loss, tl.motion_sparsity_loss, [m.astype(np.float32)], skip_zeros=not zero)
