"""PackNet01 on the MonoDepth2 train step: the port vs the JAX package on the CPU.

``projects/MonoDepth2/configs/packnet_1a.yaml`` (PackNet01 1A + PoseNet, N=2,
``adam_multistep``) in float32 at B=2, 64x128, with one flipped sample; 1B by
``MODEL.DEPTH_NET.VERSION``. Weights: the port's seeded init, carried to the
JAX tree by the JAX package's own ``convert_meta_arch`` (``convert_packnet``
reads the port's names; a Flax ``init`` of this 128 M-parameter net takes
16-35 s on the CPU), perturbed with numpy (the 3D convolutions' biases too) and
loaded back with ``load_flax_variables``. One jitted JAX value-and-gradient
gives the losses and the gradient, and with the JAX package's optax chain the
3-step trajectory. bfloat16: the JAX function compiled with
``xla_allow_excess_precision`` off, as ``test_torch_bf16_parity.py`` does.

Measured on an 8-core CPU (2 torch threads), limits beside:
- space-to-depth and depth-to-space equal; the packed 3D convolution equal at
  these sizes (1e-5 of its largest value).
- depth, every scale, per pixel relative: 1A 5.1e-6, 1B 5.5e-6 (5e-5).
- loss dict relative per key 1.0e-6 (1e-5); gradient per tensor ``max|Δ| /
  max|g|`` 1.9e-4 at most (``pose_net.pose_pred.weight``; 1e-3, plus a floor
  of 1e-6 of the largest gradient for ``pose_net.conv1.0.bias``, which a
  GroupNorm of one channel per group removes: rounding noise on both sides),
  median 5.9e-6 (3e-5).
- 3 steps: losses 2.6e-5 (2e-3), ``grad_norm`` 3.5e-4 at the first step and
  9.0e-4 after it (1e-3, then 5e-3), parameters relative L2 1.7e-5 (2e-3),
  the update itself 8.6e-4 (5e-2).
- bfloat16: the median pixel, ``test_torch_bf16_parity.py``'s check, cannot be
  the check here, for the reason ``test_torch_bts_bf16.py`` gives: some 40
  convolutions of fan-in up to 2048·25 chain through GroupNorms, and a rounding
  flip of one moves the next one's sums, so by the last one only a third of the
  pixels sit on the JAX package's bfloat16 value (median 1.5e-3; the float32
  port 2.2e-3). Losses 2.6e-4 (6e-4), the share of depth pixels within 1e-6 of
  the JAX package's value 33.1 % (at least 15 %); the port in float32 (the
  control): losses 1.4e-3 and 0.04 %, outside both.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu.models import packnet as jax_packnet
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu.solver.build import build_optimizer as jax_build_optimizer
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models import packnet
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict, load_flax_variables
from simpledepthestimation_tpu_torch.models.norm_layers import Conv3d
from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

from torch_port_helpers import (
    REPO, batch_to_torch, make_batch, nchw, nhwc, shared_variables, to_numpy_tree,
)

B, H, W, N = 2, 64, 128, 2
CONFIG = os.path.join(REPO, "projects", "MonoDepth2", "configs", "packnet_1a.yaml")
STEPS_PER_EPOCH = 2
# the rate drops by GAMMA after the first "epoch" of two steps, inside the trajectory
OVERRIDES = ["SOLVER.LR_STEPS", "(1,)"]
N_STEPS = 3
# the limits and what they were set from: module docstring
CONV3D_RTOL, DEPTH_RTOL, LOSS_RTOL, GRAD_RTOL, GRAD_MEDIAN = 1e-5, 5e-5, 1e-5, 1e-3, 3e-5
BF16_LOSS_RTOL, BF16_SAME_SHARE = 6e-4, 0.15
ROUND_AS_WRITTEN = {"xla_allow_excess_precision": False}


def _cfgs(dtype="float32", extra=()):
    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(["TPU.COMPUTE_DTYPE", dtype, *OVERRIDES, *extra])
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _params(version="1A"):
    """The Flax ``params`` (numpy) of one PackNet model of ``version``: the port's
    seeded init through ``shared_variables``, with the 3D convolutions' biases
    perturbed as well (``randomize_variables`` perturbs leaves named ``bias``;
    these are ``conv3d_bias``). Made once per version, shared by the tests."""
    cfg_j, cfg_t = _cfgs(extra=["MODEL.DEPTH_NET.VERSION", version])
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    params = shared_variables(port, cfg_j)["params"]
    rng = np.random.RandomState(101)

    def walk(tree):
        return {k: (walk(v) if hasattr(v, "items") else
                    (0.1 * rng.randn(*np.shape(v))).astype(np.float32) if k == "conv3d_bias" else v)
                for k, v in tree.items()}

    return walk(params)


def _port(cfg_t, version="1A"):
    """The port's model of ``cfg_t`` on the CPU with :func:`_params` loaded."""
    return load_flax_variables(build_model(cfg_t, device="cpu"), _params(version))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batches():
    return [make_batch(seed=10 + i % 2, B=B, H=H, W=W, N=N, smooth=True, flip=(False, i % 2 == 1))
            for i in range(N_STEPS)]


def test_space_to_depth_and_back_match_jax():
    x = np.random.RandomState(0).randn(2, 6, 10, 12).astype(np.float32)  # NHWC
    packed = packnet.space_to_depth(nchw(x))
    np.testing.assert_array_equal(nhwc(packed), np.asarray(jax_packnet.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(nhwc(packnet.depth_to_space(nchw(x))),
                                  np.asarray(jax_packnet.depth_to_space(jnp.asarray(x))))
    np.testing.assert_array_equal(packnet.depth_to_space(packed).numpy(), nchw(x).numpy())


def test_packed_conv3d_matches_jax():
    """``Conv3d(1, 8, 3)`` over the channels, folded back d-major, against the JAX
    package's own ``_conv3d_over_packed`` (NDHWC on the CPU) with a bias."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 10, 12).astype(np.float32)
    kernel = rng.randn(3, 3, 3, 1, 8).astype(np.float32)  # flax DHWIO
    bias = rng.randn(8).astype(np.float32)
    want = np.asarray(jax_packnet._conv3d_over_packed(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    conv = Conv3d(1, 8, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2).copy()))
        conv.bias.copy_(torch.from_numpy(bias))
        got = nhwc(packnet.conv3d_over_packed(conv, nchw(x)))
    assert got.shape == want.shape == (2, 6, 10, 8 * 12)
    assert np.abs(got - want).max() <= CONV3D_RTOL * np.abs(want).max()


@pytest.mark.parametrize("version", ["1A", "1B"])
def test_depth_matches_jax(version):
    """The depth net alone, all four scales, one sample flipped."""
    cfg_j, cfg_t = _cfgs(extra=["MODEL.DEPTH_NET.VERSION", version])
    port = _port(cfg_t, version)
    params = _params(version)
    net_j = jax_packnet.PackNet01.from_cfg(cfg_j)
    rng = np.random.RandomState(3)
    img = ((rng.rand(B, H, W, 3) - 0.45) / 0.225).astype(np.float32)
    flip = np.array([False, True])
    want = jax.jit(lambda p, x, f: net_j.apply({"params": p}, x, f))(params["depth_net"], img, flip)
    with torch.no_grad():
        got = port.depth_net(nchw(img), flip=torch.from_numpy(flip))
    assert len(got) == len(want) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        g, w = nhwc(g), np.asarray(w)
        assert g.shape == w.shape == (B, H >> s, W >> s, 1) and g.dtype == np.float32
        assert np.abs(g / w - 1).max() <= DEPTH_RTOL, (s, np.abs(g / w - 1).max())


def test_build_places_packnet_on_the_card_unless_asked():
    _, cfg_t = _cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg_t)
    model = build_model(cfg_t, device="cpu")
    assert type(model.depth_net).__name__ == "PackNet01" and next(model.parameters()).device.type == "cpu"
    assert sum(p.numel() for p in model.depth_net.parameters()) == 128_294_020
    with pytest.raises(ValueError, match="multiples of 32"):
        model.depth_net(torch.zeros(1, 3, 48, 128))


def _trajectories():
    """Both sides' 3-step ``adam_multistep`` trajectory from one set of weights:
    per step the metrics, at the first step the whole gradient, and at the end
    the parameters. The JAX side: one jitted function of the loss, its gradient
    and the JAX package's optax chain."""
    cfg_j, cfg_t = _cfgs()
    state = create_train_state(cfg_t, device="cpu", model=_port(cfg_t), steps_per_epoch=STEPS_PER_EPOCH)
    params = _params()
    batches = _batches()

    model_j = build_model_jax(cfg_j)

    def loss_fn(p, batch):
        out = model_j.apply({"params": p}, batch, train=True)
        return sum(v for k, v in out.items() if "loss" in k), out

    tx, _ = jax_build_optimizer(cfg_j, STEPS_PER_EPOCH)

    @jax.jit
    def step_j(p, opt, batch):
        """The loss dict, the gradient, its global norm and the updated parameters
        and optimizer state: every eager op over the tree's leaves would compile
        once per shape."""
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, batch)
        updates, opt = tx.update(grads, opt, p)
        return loss, out, grads, optax.global_norm(grads), optax.apply_updates(p, updates), opt

    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = jax.jit(tx.init)(p)
    jax_run = []
    for i, batch in enumerate(batches):
        loss, out, grads, norm, p, opt = step_j(p, opt, _jb(batch))
        jax_run.append({"total_loss": float(loss), "grad_norm": float(norm), **{k: float(v) for k, v in out.items()}})
        if i == 0:
            jax_grads = flax_to_state_dict(to_numpy_tree(grads))
    jax_params = flax_to_state_dict(to_numpy_tree(p))

    step = make_train_step(state)
    start = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    port_run = []
    for i, batch in enumerate(batches):
        port_run.append({k: float(v) for k, v in step(batch_to_torch(batch)).items()})
        if i == 0:
            port_grads = {k: q.grad.numpy().copy() for k, q in state.model.named_parameters()}
    port_params = {k: v.detach() for k, v in state.model.named_parameters()}
    return jax_run, jax_grads, jax_params, port_run, port_grads, port_params, start


@pytest.fixture(scope="module")
def trajectories():
    return _trajectories()


def test_loss_dict_and_gradient_match_jax(trajectories):
    jax_run, jax_grads, _, port_run, port_grads, _, _ = trajectories
    (want, got) = jax_run[0], port_run[0]
    assert set(got) == set(want) == {"total_loss", "grad_norm", "rec_loss", "smooth_loss"}
    for k in ("total_loss", "rec_loss", "smooth_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert set(port_grads) == set(jax_grads) and len(port_grads) > 200
    # pose_net.conv1.0.bias feeds a GroupNorm with one channel per group, which removes
    # it: its gradient is rounding noise on both sides. Hence the floor, 1e-6 of the
    # largest gradient of any tensor.
    floor = 1e-6 * max(np.abs(w).max() for w in jax_grads.values())
    errs, bad = {}, {}
    for name, g in port_grads.items():
        w = jax_grads[name]
        assert np.abs(w).max() > 0, f"{name}: the JAX gradient is identically zero"
        err = np.abs(g - w).max()
        errs[name] = float(err / np.abs(w).max())
        if not err <= GRAD_RTOL * np.abs(w).max() + floor:
            bad[name] = errs[name]
    assert not bad, bad
    assert float(np.median(list(errs.values()))) <= GRAD_MEDIAN
    # both nets and every packing stage hang on the loss
    assert {k.split(".")[1] for k in errs if k.startswith("depth_net.")} >= {f"pack{i}" for i in range(1, 6)}
    assert any(k.startswith("pose_net.") for k in errs)


def test_three_step_trajectory_matches_jax(trajectories):
    jax_run, _, jax_params, port_run, _, port_params, start = trajectories
    for i, (m, jm) in enumerate(zip(port_run, jax_run)):
        for k in ("total_loss", "rec_loss", "smooth_loss"):
            np.testing.assert_allclose(m[k], jm[k], rtol=2e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-3 if i == 0 else 5e-3,
                                   err_msg=f"step {i}")
    # squared norms summed tensor by tensor in float64: the start, the port's and the JAX package's end
    sq = {"va_vb": 0.0, "vb": 0.0, "va_v0": 0.0, "update": 0.0, "vb_v0": 0.0}
    for k, a in port_params.items():
        a, b, a0 = a.double(), torch.from_numpy(jax_params[k]).double(), start[k].double()
        for key, v in (("va_vb", a - b), ("vb", b), ("va_v0", a - a0), ("update", (a - a0) - (b - a0)),
                       ("vb_v0", b - a0)):
            sq[key] += float((v * v).sum())
    assert sq["va_v0"] ** 0.5 > 1e-3  # the parameters did move
    assert (sq["va_vb"] / sq["vb"]) ** 0.5 <= 2e-3
    assert (sq["update"] / sq["vb_v0"]) ** 0.5 <= 5e-2


def test_flax_tree_round_trip_through_the_jax_converter():
    """``convert_meta_arch`` of the port's ``state_dict`` gives back the tree
    ``load_flax_variables`` read, and an unknown leaf is refused."""
    cfg_j, cfg_t = _cfgs()
    port = _port(cfg_t)
    params = _params()
    back, stats = convert_meta_arch(port.state_dict(), cfg_j)
    assert not stats

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    want, got = flat(params), flat(back)
    assert got.keys() == want.keys() and len(got) > 200
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    dn = params["depth_net"]
    unknown = {**params, "depth_net": {**dn, "pack3": {**dn["pack3"], "conv3d_scale": np.ones(8, np.float32)}}}
    with pytest.raises(ValueError, match="pack3"):
        load_flax_variables(port, unknown)


def test_remat_changes_memory_not_math():
    """``TPU.REMAT`` on PackNet: its residual blocks, pack and unpack layers and
    ``iconv`` stages are the units recomputed in the backward; one step with and
    one without give the same metrics and gradients. Not to the bit: two runs of
    this step in one process, with or without REMAT, differ by up to 1.1e-6 of
    a tensor's largest gradient (the CPU's reductions), so the limit is 1e-5
    with the gradient floor of :func:`test_loss_dict_and_gradient_match_jax`."""
    from simpledepthestimation_tpu_torch.parallel.train_step import _rematerialised

    _, cfg_t = _cfgs()
    batch = batch_to_torch(make_batch(seed=5, B=1, H=32, W=64, N=N, smooth=True))
    runs = []
    for remat in (False, True):
        state = create_train_state(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
        if remat:
            with _rematerialised(state.model, None):
                units = [k for k, m in state.model.named_modules() if "forward" in vars(m)]
            assert {u.split(".")[1] for u in units if u.startswith("depth_net.")} == (
                {f"conv{i}" for i in range(2, 6)} | {f"{p}{i}" for p in ("pack", "unpack", "iconv") for i in range(1, 6)})
        metrics = make_train_step(state, remat=remat)(batch)
        runs.append((metrics, {k: p.grad.clone() for k, p in state.model.named_parameters()}))
    (m0, g0), (m1, g1) = runs
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6, err_msg=k)
    floor = 1e-6 * max(float(g.abs().max()) for g in g0.values())
    bad = {k: float((g1[k] - g0[k]).abs().max()) for k in g0
           if not float((g1[k] - g0[k]).abs().max()) <= 1e-5 * float(g0[k].abs().max()) + floor}
    assert not bad, bad


def _bf16_outputs():
    """(loss dict, depth_pred NHWC) of the JAX package in bfloat16 and of the port
    in bfloat16 and, on the same weights, in float32."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    port = _port(cfg_t)
    params = _params()
    port_f32 = build_model(_cfgs("float32")[1], device="cpu")
    port_f32.load_state_dict(port.state_dict())
    model_j = build_model_jax(cfg_j)
    batch = make_batch(seed=7, B=B, H=H, W=W, N=N, smooth=True, flip=(False, True))
    jb = _jb(batch)

    def both(p, b):
        return model_j.apply({"params": p}, b, train=True), model_j.apply({"params": p}, b)["depth_pred"]

    losses, depth = jax.jit(both).lower(params, jb).compile(compiler_options=ROUND_AS_WRITTEN)(params, jb)
    out = {"jax": ({k: float(v) for k, v in losses.items()}, np.asarray(depth))}
    tb = batch_to_torch(batch)
    for key, model in (("port_bf16", port), ("port_f32", port_f32)):
        with torch.no_grad():
            depth = model(tb, train=False)["depth_pred"]
            losses = model(tb, train=True)
        assert all(p.dtype == torch.float32 for p in model.parameters()) and depth.dtype == torch.float32
        out[key] = ({k: float(v) for k, v in losses.items()}, nhwc(depth))
    return out


@pytest.fixture(scope="module")
def bf16_outputs():
    return _bf16_outputs()


def _bf16_errors(port, ref):
    """The loss dict's largest relative error; the share of depth pixels within
    1e-6 (relative) of the reference's value."""
    (losses, depth), (ref_losses, ref_depth) = port, ref
    assert set(losses) == set(ref_losses) == {"rec_loss", "smooth_loss"} and depth.shape == ref_depth.shape
    rel = np.abs(depth - ref_depth) / np.abs(ref_depth)
    return max(abs(losses[k] - ref_losses[k]) / abs(ref_losses[k]) for k in ref_losses), float((rel <= 1e-6).mean())


def test_bf16_losses_and_depth_match_jax(bf16_outputs):
    loss_err, same = _bf16_errors(bf16_outputs["port_bf16"], bf16_outputs["jax"])
    assert np.isfinite(bf16_outputs["port_bf16"][1]).all()
    assert loss_err <= BF16_LOSS_RTOL and same >= BF16_SAME_SHARE, (loss_err, same)


def test_float32_port_fails_the_bf16_checks(bf16_outputs):
    """The control: the same weights computing in float32 lie outside the loss's
    limit and put almost no depth pixel on the JAX package's bfloat16 values."""
    loss_err, same = _bf16_errors(bf16_outputs["port_f32"], bf16_outputs["jax"])
    assert loss_err > BF16_LOSS_RTOL and same < BF16_SAME_SHARE, (loss_err, same)
