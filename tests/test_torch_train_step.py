"""The training slice as a whole: the port's train step vs the JAX package's on
the CPU, MonoDepth2-R18 in float32 at B=2, 64x128, N=2, on shared weights and
shared batches.

Weights: initialised by the JAX model, perturbed with numpy, carried across by
``load_flax_variables``; gradients and trained parameters come back the same
way (a Flax tree of gradients has the layout of ``params``). Batches are the
smooth ones of ``torch_port_helpers.make_batch``: on white noise the automask
cuts the warp off from the loss and the comparison would say nothing about the
warp's and the photometric map's gradients.

Limits: gradient per tensor ``max|Δ| ≤ 1e-4·max|g|`` (two ResNet-18 sized
float32 backward passes summed in another order); trajectory: per-step loss
rtol 2e-3, final parameters relative L2 ≤ 2e-3 and cosine ≥ 1−1e-6 (Adam
divides by √v, which amplifies last-bit differences of tiny gradients; the
bounds of the JAX package's own trajectory tests), ``grad_norm`` rtol 1e-3 at
the first step and 5e-3 after it (Adam's first updates have the size of the
rate whatever the gradient's, so rounding noise in a near-zero gradient moves
its parameter fully), running statistics per tensor ``max|Δ| ≤ 2e-3·max|s|``
after the three updates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu.parallel.mesh import build_mesh
from simpledepthestimation_tpu.parallel.train_step import TrainState as JTrainState
from simpledepthestimation_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from simpledepthestimation_tpu.parallel.train_step import make_train_step as jax_make_train_step
from simpledepthestimation_tpu.solver.build import build_optimizer as jax_build_optimizer
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables
from simpledepthestimation_tpu_torch.parallel import (
    TrainState, create_train_state, make_eval_step, make_train_step,
)

from torch_port_helpers import (
    batch_to_torch, init_jax_monodepth2, make_batch, monodepth2_cfgs, nhwc, to_numpy_tree,
)

B, H, W, N = 2, 64, 128, 2
STEPS_PER_EPOCH = 2
# the rate drops by GAMMA after the first "epoch" of two steps, inside the trajectory
OVERRIDES = ["SOLVER.LR_STEPS", "(1,)", "SOLVER.DEPTH_LR", "2e-4", "SOLVER.POSE_LR", "1e-4"]
N_STEPS = 3


def _batches():
    return [make_batch(seed=10 + i % 2, B=B, H=H, W=W, N=N, smooth=True, flip=(False, i % 2 == 1))
            for i in range(N_STEPS)]


@pytest.fixture(scope="module")
def shared():
    cfg_j, _ = monodepth2_cfgs(OVERRIDES)
    batches = _batches()
    _, variables = init_jax_monodepth2(cfg_j, batches[0])
    return batches, variables


def _port_state(variables):
    _, cfg_t = monodepth2_cfgs(OVERRIDES)
    state = create_train_state(cfg_t, device="cpu", steps_per_epoch=STEPS_PER_EPOCH)
    load_flax_variables(state.model, variables["params"], variables["batch_stats"])
    return cfg_t, state


def _as_state_dict(cfg_t, params, batch_stats):
    """A Flax tree in the layout of ``params`` → the port's ``state_dict``."""
    model = build_model(cfg_t, device="cpu")
    load_flax_variables(model, to_numpy_tree(params), to_numpy_tree(batch_stats))
    return model.state_dict()


def _flat(sd, keys):
    return np.concatenate([sd[k].detach().numpy().astype(np.float64).ravel() for k in keys])


def _run_jax_trajectory(variables, batches, grad_clip):
    cfg_j, _ = monodepth2_cfgs(OVERRIDES)
    model = build_model_jax(cfg_j)
    tx, _ = jax_build_optimizer(cfg_j, STEPS_PER_EPOCH)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                        opt_state=tx.init(params))
    mesh = build_mesh(shape=(1,))
    step = jax_make_train_step(model, tx, mesh, donate=False, grad_clip=grad_clip, adaptive_ywin=0)
    metrics = []
    for i, batch in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    depth = np.asarray(jax_make_eval_step(model, mesh)(state, {k: jnp.asarray(v) for k, v in batches[0].items()}))
    return state, metrics, depth


def _run_port_trajectory(variables, batches, grad_clip):
    cfg_t, state = _port_state(variables)
    step = make_train_step(state, grad_clip=grad_clip)
    metrics = [step(batch_to_torch(b)) for b in batches]
    depth = make_eval_step(state)(batch_to_torch(batches[0]))
    return cfg_t, state, metrics, depth


def _assert_trajectories_match(variables, batches, grad_clip):
    j_state, j_metrics, j_depth = _run_jax_trajectory(variables, batches, grad_clip)
    cfg_t, state, metrics, depth = _run_port_trajectory(variables, batches, grad_clip)

    # (e) metrics are tensors; step count and rate advanced
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 and not v.requires_grad
               for m in metrics for v in m.values())
    assert state.step == N_STEPS == int(j_state.step)
    assert state.scheduler.get_last_lr() == pytest.approx([2e-5, 1e-5])
    assert [g["name"] for g in state.optimizer.param_groups] == ["depth", "pose"]

    for i, (m, jm) in enumerate(zip(metrics, j_metrics)):
        assert set(m) == set(jm) == {"total_loss", "grad_norm", "rec_loss", "smooth_loss"}
        for k in ("total_loss", "rec_loss", "smooth_loss"):
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=2e-3, err_msg=f"step {i} {k}")
        # step 0 compares one gradient; later steps also the drift of the parameters
        np.testing.assert_allclose(float(m["grad_norm"]), jm["grad_norm"], rtol=1e-3 if i == 0 else 5e-3,
                                   err_msg=f"step {i}")
    if grad_clip > 0:  # small enough to bite at every step
        assert all(jm["grad_norm"] > 2 * grad_clip for jm in j_metrics)

    want = _as_state_dict(cfg_t, j_state.params, j_state.batch_stats)
    have = state.model.state_dict()
    p_keys = [k for k, _ in state.model.named_parameters()]
    va, vb = _flat(have, p_keys), _flat(want, p_keys)
    start = _flat(_as_state_dict(cfg_t, variables["params"], variables["batch_stats"]), p_keys)
    assert np.linalg.norm(va - start) > 1e-3  # the parameters did move
    cos = float(va @ vb) / float(np.linalg.norm(va) * np.linalg.norm(vb))
    rel_l2 = float(np.linalg.norm(va - vb) / np.linalg.norm(vb))
    assert cos >= 1 - 1e-6, cos
    assert rel_l2 <= 2e-3, rel_l2
    # the update itself, not only the end point that the start dominates
    moved = float(np.linalg.norm((va - start) - (vb - start)) / np.linalg.norm(vb - start))
    assert moved <= 5e-2, moved

    # batch_stats: equal now that the running variance follows the Flax rule
    s_keys = [k for k in have if k.endswith(("running_mean", "running_var"))]
    assert len(s_keys) == 40
    for k in s_keys:
        # the statistics of the deep layers (16 values per channel) follow the
        # parameters, which are held to 2e-3 above; the first update alone agrees
        # to 1e-4 (test_torch_models). The unbiased rule would be off by 2e-2 here.
        err = float((have[k] - want[k]).abs().max() / want[k].abs().max())
        assert err <= 2e-3, (k, err)
    assert all(int(have[k]) == N_STEPS for k in have if k.endswith("num_batches_tracked"))

    # (d) the eval step after training: on the port's own trained state within
    # the parameters' bound, on the JAX-trained state (same weights and running
    # statistics on both sides) within the forward's 1e-4
    assert depth.shape == (B, 1, H, W)
    np.testing.assert_allclose(nhwc(depth), j_depth, rtol=2e-3, atol=0)
    state.model.load_state_dict(want)
    depth_same = make_eval_step(state)(batch_to_torch(batches[0]))
    np.testing.assert_allclose(nhwc(depth_same), j_depth, rtol=1e-4, atol=0)


def test_parameter_gradient_matches_jax_grad(shared):
    batches, variables = shared
    cfg_j, cfg_t = monodepth2_cfgs(OVERRIDES)
    model_j = build_model_jax(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(params):
        out, _ = model_j.apply({"params": params, "batch_stats": variables["batch_stats"]}, jb,
                               train=True, mutable=["batch_stats"])
        return sum(v for k, v in out.items() if "loss" in k)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = _as_state_dict(cfg_t, grads_j, variables["batch_stats"])

    model_t = build_model(cfg_t, device="cpu")
    load_flax_variables(model_t, variables["params"], variables["batch_stats"])
    out = model_t(batch_to_torch(batches[0]), train=True)
    total = sum(out.values())
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss_j), rtol=1e-5)

    names = [k for k, _ in model_t.named_parameters()]
    assert len(names) > 100
    # pose_net.conv1.0.bias feeds a GroupNorm with one channel per group, which
    # removes it: its gradient is rounding noise (1e-8) on both sides. Hence the
    # floor, 1e-6 of the largest gradient of any tensor.
    floor = 1e-6 * max(float(w.abs().max()) for w in want.values())
    bad = {}
    for name, p in model_t.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        assert np.abs(w).max() > 0, f"{name}: the JAX gradient is identically zero"
        err = np.abs(g - w).max()
        if not err <= 1e-4 * np.abs(w).max() + floor:
            bad[name] = (err, np.abs(w).max())
    assert not bad, bad
    # both nets hang on the loss through the warp's coordinate gradient
    assert any(k.startswith("pose_net.") for k in names) and any(k.startswith("depth_net.") for k in names)


def test_trajectory_matches_jax_train_step(shared):
    batches, variables = shared
    _assert_trajectories_match(variables, batches, grad_clip=0.0)


def test_trajectory_with_gradient_clipping_matches_jax(shared):
    batches, variables = shared
    _assert_trajectories_match(variables, batches, grad_clip=0.05)


def test_train_state_and_step_contract(shared):
    """What the step promises apart from the numbers."""
    batches, variables = shared
    _, cfg_t = monodepth2_cfgs(OVERRIDES)
    if not torch.cuda.is_available():  # the card unless the caller names the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_train_state(cfg_t)
    state = create_train_state(cfg_t, device="cpu", generator=torch.Generator().manual_seed(5),
                               steps_per_epoch=STEPS_PER_EPOCH)
    assert isinstance(state, TrainState) and state.step == 0
    assert state.scheduler.get_last_lr() == pytest.approx([2e-4, 1e-4])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_train_step(state)
    metrics = step(batch_to_torch(batches[0]))
    assert state.step == 1 and state.scheduler.last_step == 1
    assert float(metrics["grad_norm"]) > 0
    np.testing.assert_allclose(float(metrics["total_loss"]),
                               float(metrics["rec_loss"]) + float(metrics["smooth_loss"]), rtol=1e-6)
    after = state.model.state_dict()
    unchanged = [k for k, p in state.model.named_parameters() if torch.equal(before[k], after[k])]
    assert not unchanged, unchanged
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moments = [s["exp_avg"] for s in state.optimizer.state.values()]
    assert len(moments) == len(before) - sum(not k.endswith(("weight", "bias")) for k in before)
    assert all(m.dtype == torch.float32 for m in moments)
    # eval step: running statistics, no gradient, nothing updated
    depth = make_eval_step(state)(batch_to_torch(batches[0]))
    assert depth.shape == (B, 1, H, W) and not depth.requires_grad
    assert all(torch.equal(v, after[k]) for k, v in state.model.state_dict().items())
