"""The MotionLearning slice as a whole: the port vs the JAX package on the CPU.

``projects/MotionLearning/configs/resnet18.yaml`` with a random-init encoder
(``ENCODER_NAME 18``) in float32 at B=2, 64x96: GoogleResNet-18 with randLN +
GoogleMotionNet (RGB-D, clip_ste scales, masked motion). Weights: the port's
seeded init, carried to the JAX model by the JAX package's own
``convert_meta_arch``, perturbed with numpy, and loaded back with
``load_flax_variables``; gradients come back the same way.

The batch is one pair of smooth frames (the second the first shifted by two
pixels, plus a little noise). Two of the model's masks are strict comparisons
(occlusion: ``depth_in_B < sampled_depth_B``; motion: ``|m| > mean|m|``), so
the test counts the pixels where the port's masks differ from the JAX
package's (read from the JAX model's captured intermediates) and asserts
none. Even so, some batches are ill-conditioned in float32: the cycle loss's
``R_A2B·R_B2A − I`` is a difference of nearly equal matrices and the
structure-only SSIM divides by window variances near C2 = 9e-6, so the JAX
package's own gradient differs between its jitted and its eager evaluation by
up to 2.8e-2 per tensor on batch seed 2 and 1e-3 on seed 4 (measured over
seeds 0-9 at these weights), while the port lies within 3e-4 of one of the two.
The test uses seed 3, where the JAX package agrees with itself (1.5e-4 at
``rot_scale``, a gradient that cancels to first order, and below 1e-4
elsewhere).

Limits: loss dict 1e-4 relative per key; parameter gradient per tensor
``max|Δ| ≤ 1e-4·max|g|`` plus a floor of 1e-6 of the largest gradient of any
tensor (a gradient that is zero but for rounding); the 3-step trajectory
within the MonoDepth2 slice's bounds (loss rtol 2e-3, ``grad_norm`` 1e-3 then
5e-3, parameters rel-L2 2e-3 and cosine 1−1e-6).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu.solver.build import build_optimizer as jax_build_optimizer
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.models import build_model, make_schedule_fn
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict, load_flax_variables
from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

from torch_port_helpers import REPO, batch_to_torch, nhwc, randomize_variables, smooth_field, to_numpy_tree

B, H, W = 2, 64, 96
CONFIG = os.path.join(REPO, "projects", "MotionLearning", "configs", "resnet18.yaml")
STEPS_PER_EPOCH = 2
# the rate drops by GAMMA after the first "epoch" of two steps, inside the trajectory
OVERRIDES = ["SOLVER.LR_STEPS", "(1,)"]
BATCH_SEED = 3
LOSS_KEYS = {"rgb_l1_loss", "ssim_loss", "rot_loss", "trans_loss", "motion_smooth_loss",
             "motion_sparsity_loss", "smooth_loss"}


def _cfgs(extra=()):
    opts = ["MODEL.DEPTH_NET.ENCODER_NAME", "18", "TPU.COMPUTE_DTYPE", "float32", *OVERRIDES, *extra]
    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return tuple(out)


def _batch(seed, motion_weight=1.0, H=H, W=W):
    """A MotionLearning batch as numpy NHWC arrays (the JAX layout)."""
    rng = np.random.RandomState(seed)
    img = smooth_field(rng, B, H, W, 3)
    ctx = (np.roll(img, 2, axis=2)[:, None] + 0.01 * rng.rand(B, 1, H, W, 3)).astype(np.float32)
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    return {"img": img, "ctx_img": ctx, "intrinsics": K, "flip": np.array([False, True]),
            "noise_stddev": np.float32(0.0), "motion_weight": np.float32(motion_weight)}


@pytest.fixture(scope="module")
def shared():
    """Weights (Flax trees, numpy), the JAX model's jitted loss+gradient, and
    that gradient at these weights for a batch (``at_start(seed, motion_weight)``,
    computed once per batch: the loss-dict test and the trajectory's first step
    share it)."""
    cfg_j, cfg_t = _cfgs()
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    params, stats = convert_meta_arch(port.state_dict(), cfg_j)
    assert not stats  # randLN: no running statistics
    params = randomize_variables(to_numpy_tree(params))
    model_j = build_model_jax(cfg_j)

    def captured(module, method):
        return method == "_rgbd_consistency" or (method == "__call__" and type(module).__name__ == "GoogleMotionNet")

    def loss_fn(p, batch):
        out, inter = model_j.apply({"params": p}, batch, train=True, rngs={"noise": jax.random.PRNGKey(0)},
                                   capture_intermediates=captured, mutable=["intermediates"])
        return sum(v for k, v in out.items() if "loss" in k), (out, inter["intermediates"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    cache = {}

    def at_start(seed, motion_weight=1.0):
        if (seed, motion_weight) not in cache:
            cache[seed, motion_weight] = grad_fn(params, _jb(_batch(seed, motion_weight)))
        return cache[seed, motion_weight]

    return params, grad_fn, at_start


def _port_model(params):
    _, cfg_t = _cfgs()
    model = build_model(cfg_t, device="cpu")
    load_flax_variables(model, params)
    return model


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_weights_round_trip_through_the_jax_converter(shared):
    """``convert_meta_arch`` of the port's ``state_dict`` gives back the trees
    that ``load_flax_variables`` read: the two namings are inverse."""
    params = shared[0]
    cfg_j, _ = _cfgs()
    back, stats = convert_meta_arch(_port_model(params).state_dict(), cfg_j)
    assert not stats

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    want, got = flat(params), flat(back)
    assert got.keys() == want.keys() and len(got) > 150
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("motion_weight", [1.0, 0.0])
def test_loss_dict_and_parameter_gradient_match_jax(shared, motion_weight):
    params, _, at_start = shared
    batch = _batch(BATCH_SEED, motion_weight)
    (loss_j, (out_j, inter_j)), grads_j = at_start(BATCH_SEED, motion_weight)

    model = _port_model(params)
    with _masks_seen() as seen:
        out = model(batch_to_torch(batch), train=True, generator=torch.Generator().manual_seed(0))
    # no pixel of either mask flips between the packages (see the module docstring)
    occ_j = np.asarray(inter_j["_rgbd_consistency"][0]["occlusion_mask"])
    motion_j = np.asarray(inter_j["pose_net"]["__call__"][0][1])
    assert int((nhwc(seen["occlusion_mask"]) != occ_j).sum()) == 0
    moving = (nhwc(seen["motion"]) != 0).any(-1)
    assert int((moving != (motion_j != 0).any(-1)).sum()) == 0
    assert moving.mean() > 0.2 if motion_weight else not moving.any()
    assert set(out) == set(k for k in out_j if "loss" in k) == LOSS_KEYS
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(out[k]), float(out_j[k]), rtol=1e-4, err_msg=k)
    total = sum(out.values())
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss_j), rtol=1e-4)

    want = flax_to_state_dict(to_numpy_tree(grads_j))
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    bad, zero_j = {}, []
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name]
        if np.abs(w).max() == 0:
            zero_j.append(name)
        err = np.abs(g - w).max()
        if not err <= 1e-4 * np.abs(w).max() + floor:
            bad[name] = (err, np.abs(w).max())
    assert not bad, bad
    names = [k for k, _ in model.named_parameters()]
    assert len(names) > 150 and "pose_net.refiner0.conv3.weight" in names
    if motion_weight == 1.0:
        # every parameter hangs on the loss, the learned translation scale included
        assert not zero_j, zero_j
    else:
        # motion_weight 0 (the start of the burn-in): the motion field is zero, so the
        # refiners and the seed get no gradient on either side, and every gradient is finite
        assert all(n.startswith(("pose_net.refiner", "pose_net.conv8")) for n in zero_j) and zero_j
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
        for k in ("motion_smooth_loss", "motion_sparsity_loss"):
            assert float(out[k]) < 1e-10  # sqrt(1e-24) per pixel at most


# every option of the model that the configs of this repository leave off (the Waymo
# config sets WITH_MASK): masks, scale normalisation, the extra loss terms, two scales
OPTIONS = ["MODEL.WITH_MASK", "True", "MODEL.MASK_DILATION", "2", "LOSS.SCALE_NORMALIZE", "True",
           "LOSS.DEPTH_L1_WEIGHT", "0.1", "LOSS.SUPERVISED_WEIGHT", "0.1", "LOSS.VAR_LOSS_WEIGHT", "0.01",
           "LOSS.NUM_SCALES", "2"]


def test_loss_dict_with_every_option_matches_jax(shared):
    params = shared[0]
    cfg_j, cfg_t = _cfgs(OPTIONS)
    rng = np.random.RandomState(7)
    batch = _batch(BATCH_SEED)
    batch["mask"] = (rng.rand(B, H, W, 1) > 0.9).astype(np.float32)
    batch["ctx_mask"] = (rng.rand(B, 1, H, W, 1) > 0.9).astype(np.float32)
    batch["depth"] = (rng.rand(B, H, W, 1) * 30.0).astype(np.float32)
    batch["ctx_depth"] = (rng.rand(B, 1, H, W, 1) * 30.0).astype(np.float32)
    model_j = build_model_jax(cfg_j)
    out_j = jax.jit(lambda p, b: model_j.apply({"params": p}, b, train=True, rngs={"noise": jax.random.PRNGKey(0)}))(
        params, _jb(batch))
    model = build_model(cfg_t, device="cpu")
    load_flax_variables(model, params)
    with torch.no_grad():
        out = model(batch_to_torch(batch), train=True)
    assert set(out) == set(out_j) == LOSS_KEYS | {"depth_l1_loss", "sup_loss", "var_loss"}
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(out_j[k]), rtol=1e-4, err_msg=k)


@contextlib.contextmanager
def _masks_seen():
    """The port's occlusion mask and masked motion field of one forward."""
    from simpledepthestimation_tpu_torch.models.motion_meta_arch import MotionLearningModel
    from simpledepthestimation_tpu_torch.models.pose_nets import GoogleMotionNet

    seen = {}
    rgbd, motion_net = MotionLearningModel._rgbd_consistency, GoogleMotionNet.forward

    def rgbd_spy(self, *args):
        out = rgbd(self, *args)
        seen["occlusion_mask"] = out["occlusion_mask"].detach()
        return out

    def motion_spy(self, *args, **kwargs):
        pose, motion = motion_net(self, *args, **kwargs)
        seen["motion"] = motion.detach()
        return pose, motion

    MotionLearningModel._rgbd_consistency, GoogleMotionNet.forward = rgbd_spy, motion_spy
    try:
        yield seen
    finally:
        MotionLearningModel._rgbd_consistency, GoogleMotionNet.forward = rgbd, motion_net


def test_three_step_trajectory_matches_jax_train_step(shared):
    params, grad_fn, at_start = shared
    cfg_j, cfg_t = _cfgs()
    batches = [_batch(BATCH_SEED + i % 2) for i in range(3)]
    clip = float(cfg_j.SOLVER.GRAD_CLIP)
    assert clip == 10.0 and float(cfg_j.SOLVER.EPS) == 1e-7

    # the JAX package's step (parallel/train_step.py step_fn): value_and_grad of the
    # summed losses, global-norm clip, its optax chain; built on the jitted gradient
    # of the fixture so that the model compiles once (and the first step's gradient
    # is the loss-dict test's)
    tx, _ = jax_build_optimizer(cfg_j, STEPS_PER_EPOCH)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(p)

    @jax.jit
    def update(p, opt_state, grads):
        grad_norm = optax.global_norm(grads)
        scale = jnp.minimum(1.0, clip / (grad_norm + 1e-12))
        updates, opt_state = tx.update(jax.tree_util.tree_map(lambda g: g * scale, grads), opt_state, p)
        return optax.apply_updates(p, updates), opt_state, grad_norm

    j_metrics = []
    for i, batch in enumerate(batches):
        (total, (out, _)), grads = at_start(BATCH_SEED) if i == 0 else grad_fn(p, _jb(batch))
        p, opt_state, grad_norm = update(p, opt_state, grads)
        j_metrics.append({"total_loss": float(total), "grad_norm": float(grad_norm),
                          **{k: float(v) for k, v in out.items() if "loss" in k}})

    state = create_train_state(cfg_t, device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    load_flax_variables(state.model, params)
    step = make_train_step(state, grad_clip=clip,
                           schedule_fn=lambda s: {"noise_stddev": 0.0, "motion_weight": 1.0})
    start = torch.cat([q.detach().flatten() for q in state.model.parameters()]).double()
    metrics = []
    for batch in batches:
        tb = batch_to_torch({k: v for k, v in batch.items() if k not in ("noise_stddev", "motion_weight")})
        metrics.append({k: float(v) for k, v in step(tb).items()})

    assert state.step == 3
    assert state.scheduler.get_last_lr() == pytest.approx([1e-4, 1e-4])
    for i, (m, jm) in enumerate(zip(metrics, j_metrics)):
        assert set(m) == set(jm) == LOSS_KEYS | {"total_loss", "grad_norm"}
        for k in LOSS_KEYS | {"total_loss"}:
            np.testing.assert_allclose(m[k], jm[k], rtol=2e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-3 if i == 0 else 5e-3,
                                   err_msg=f"step {i}")

    want = flax_to_state_dict(to_numpy_tree(p))
    names = [k for k, _ in state.model.named_parameters()]
    va = torch.cat([q.detach().flatten() for q in state.model.parameters()]).double().numpy()
    vb = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in names])
    assert np.linalg.norm(va - start.numpy()) > 1e-3  # the parameters did move
    cos = float(va @ vb) / float(np.linalg.norm(va) * np.linalg.norm(vb))
    assert cos >= 1 - 1e-6, cos
    assert np.linalg.norm(va - vb) / np.linalg.norm(vb) <= 2e-3


@pytest.mark.parametrize("config", ["resnet18.yaml", "synthetic_quick.yaml"])
def test_schedule_matches_the_jax_project(config):
    from projects.MotionLearning.train import make_schedule_fn as jax_schedule_fn

    cfgs = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(os.path.join(REPO, "projects", "MotionLearning", "configs", config))
        cfgs.append(cfg)
    ours, theirs = make_schedule_fn(cfgs[1]), jax_schedule_fn(cfgs[0])
    rampup = int(cfgs[1].MODEL.DEPTH_NET.RAMPUP_ITERS)
    burn_in = int(cfgs[1].MODEL.POSE_NET.BURN_IN_ITERS)
    for step in (0, 1, rampup // 2, rampup - 1, rampup, burn_in // 2, burn_in - 1, 3 * burn_in):
        got, want = ours(step), theirs(step)
        assert set(got) == set(want) == {"noise_stddev", "motion_weight"}
        for k in got:
            assert got[k] == float(want[k]), (step, k)
    assert ours(0)["motion_weight"] == 0.0 and ours(3 * burn_in)["motion_weight"] == 1.0


def test_train_state_noise_and_schedule_scalars(shared):
    """The step hands the schedule's scalars to the model as 0-d float32
    tensors on its device, and the RandLayerNorm noise comes from the state's
    own generator (seeded from SEED): two states with one seed train alike,
    another seed trains otherwise, and the global random state is not touched.
    The ramps are cut to 1 and 2 steps so that the noise is at full strength
    and the motion weight goes from 0 to 1 within two steps; the frames are
    32x64, since nothing here is compared with the JAX package."""
    params = shared[0]
    runs = []
    for seed in (4, 4, 5):
        _, cfg_t = _cfgs(["SEED", str(seed), "MODEL.DEPTH_NET.RAMPUP_ITERS", "1",
                          "MODEL.POSE_NET.BURN_IN_ITERS", "2"])
        state = create_train_state(cfg_t, device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
        assert state.noise_generator.device.type == "cpu" and state.noise_generator.initial_seed() == seed
        load_flax_variables(state.model, params)
        seen = []
        forward = state.model.forward

        def spy(batch, train=False, generator=None):
            seen.append({k: v for k, v in batch.items() if k in ("noise_stddev", "motion_weight")})
            assert generator is state.noise_generator
            return forward(batch, train=train, generator=generator)

        state.model.forward = spy
        step = make_train_step(state, grad_clip=10.0, schedule_fn=make_schedule_fn(cfg_t))
        torch.manual_seed(0)
        before = torch.get_rng_state()
        tb = batch_to_torch({k: v for k, v in _batch(BATCH_SEED, H=32, W=64).items()
                             if k not in ("noise_stddev", "motion_weight")})
        runs.append([float(step(tb)["total_loss"]) for _ in range(2)])
        assert torch.equal(torch.get_rng_state(), before)
        assert [{k: float(v) for k, v in scalars.items()} for scalars in seen] == [
            {"noise_stddev": 0.5, "motion_weight": 0.0}, {"noise_stddev": 0.5, "motion_weight": 1.0}]
        assert all(v.dim() == 0 and v.dtype == torch.float32 for scalars in seen for v in scalars.values())
    assert runs[0] == runs[1] and runs[0] != runs[2]
