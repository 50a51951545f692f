"""The port's optimizers and schedules vs the JAX package's (optax) on the CPU.

Schedules: the port evaluates them in Python floats, the JAX package in
float32: 1e-6 relative. Updates: three steps of each recipe on a small seeded
parameter tree with seeded gradients, against ``optax`` through the JAX
package's ``build_optimizer``: 1e-6 absolute on parameters of order 1 (float32
on both sides, the same formula).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
import optax

from simpledepthestimation_tpu.solver import build as jsolver
from simpledepthestimation_tpu_torch.solver import (
    ScheduledLR, build_optimizer, multistep_lr_schedule, param_groups_by_name, poly_lr_schedule,
)

from torch_port_helpers import monodepth2_cfgs


def _cfgs(overrides):
    return monodepth2_cfgs(list(overrides))


class _Tiny(nn.Module):
    """Parameter names that exercise the grouping rules: an encoder and a
    decoder under ``depth_net``, and a ``pose_net``."""

    def __init__(self, rng):
        super().__init__()
        self.depth_net = nn.ModuleDict({
            "encoder": nn.Linear(4, 3), "decoder": nn.Linear(3, 2),
        })
        self.pose_net = nn.Linear(5, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))


def _as_tree(model):
    """The module's parameters as the nested dict the JAX label functions walk."""
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(p.detach().numpy())
    return tree


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


MILESTONES = [6, 15]


@pytest.mark.parametrize("step", [0, 1, 5, 6, 7, 14, 15, 16, 40])
def test_multistep_schedule_matches_jax(step):
    ref = jsolver.multistep_lr_schedule(2e-4, MILESTONES, 0.1)(step)
    got = multistep_lr_schedule(2e-4, MILESTONES, 0.1)(step)
    np.testing.assert_allclose(got, float(ref), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 17, 49, 50, 51, 99, 100, 101, 1000])
def test_poly_schedule_matches_jax(step):
    ref = jsolver.poly_lr_schedule(1e-4, 1e-5, 100)(step)
    got = poly_lr_schedule(1e-4, 1e-5, 100)(step)
    np.testing.assert_allclose(got, float(ref), rtol=1e-6)
    assert poly_lr_schedule(1e-4, 1e-5, 100)(100) == pytest.approx(1e-5)


def test_group_membership(rng):
    model = _Tiny(rng)
    by_id = {id(p): n for n, p in model.named_parameters()}
    groups = param_groups_by_name(model, {"pose": ["pose_net"]}, default="depth")
    assert list(groups) == ["pose", "depth"]
    assert {by_id[id(p)] for p in groups["pose"]} == {"pose_net.weight", "pose_net.bias"}
    assert all(by_id[id(p)].startswith("depth_net.") for p in groups["depth"]) and len(groups["depth"]) == 4
    groups = param_groups_by_name(model, {"encoder": ["encoder"]}, default="decoder")
    assert {by_id[id(p)] for p in groups["encoder"]} == {"depth_net.encoder.weight", "depth_net.encoder.bias"}
    assert len(groups["decoder"]) == 4  # the decoder and the pose net: everything else
    # a frozen parameter belongs to no group
    model.pose_net.bias.requires_grad_(False)
    assert len(param_groups_by_name(model, {"pose": ["pose_net"]}, default="depth")["pose"]) == 1

    _, cfg = _cfgs(["SOLVER.DEPTH_LR", "3e-4", "SOLVER.POSE_LR", "1e-4"])
    model = _Tiny(rng)
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=2)
    assert isinstance(opt, torch.optim.Adam) and not isinstance(opt, torch.optim.AdamW)
    assert [(g["name"], g["lr"], len(g["params"])) for g in opt.param_groups] == [("depth", 3e-4, 4), ("pose", 1e-4, 2)]
    assert opt.defaults["eps"] == 1e-8 and sched.get_last_lr() == [3e-4, 1e-4]

    _, cfg = _cfgs(["SOLVER.OPT", "adamw_poly", "SOLVER.WEIGHT_DECAY", "0.02"])
    opt, _ = build_optimizer(cfg, model, steps_per_epoch=2)
    assert isinstance(opt, torch.optim.AdamW) and opt.defaults["eps"] == 1e-6
    assert [(g["name"], g["weight_decay"], len(g["params"])) for g in opt.param_groups] == [
        ("encoder", 0.02, 2), ("decoder", 0.0, 4)]


def test_unknown_recipe_raises_and_end_lr_alias(rng):
    model = _Tiny(rng)
    _, cfg = _cfgs(["SOLVER.OPT", "sgd"])
    with pytest.raises(ValueError, match="Unknown SOLVER.OPT"):
        build_optimizer(cfg, model, 1)
    for key in ("DEPTH_END_LR", "END_LR"):
        _, cfg = _cfgs(["SOLVER.OPT", "adamw_poly", "SOLVER.DEPTH_LR", "1e-3", "SOLVER.MAX_EPOCHS", "1"])
        cfg.SOLVER[key] = 5e-4
        opt, sched = build_optimizer(cfg, model, steps_per_epoch=10)
        for _ in range(10):
            sched.step()
        assert sched.get_last_lr() == pytest.approx([5e-4, 5e-4])
    with pytest.raises(ValueError, match="schedules"):
        ScheduledLR(opt, [lambda s: 1.0])


def test_scheduled_lr_counts_steps_and_restores(rng):
    model = _Tiny(rng)
    _, cfg = _cfgs(["SOLVER.LR_STEPS", "(1, 2)", "SOLVER.DEPTH_LR", "1e-3", "SOLVER.POSE_LR", "1e-4"])
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=3)
    seen = []
    for _ in range(7):
        seen.append(sched.get_last_lr()[0])
        sched.step()
    np.testing.assert_allclose(seen, [1e-3] * 3 + [1e-4] * 3 + [1e-5], rtol=1e-12)
    state = sched.state_dict()
    opt2, sched2 = build_optimizer(cfg, model, steps_per_epoch=3)
    sched2.load_state_dict(state)
    assert sched2.last_step == 7 and sched2.get_last_lr() == sched.get_last_lr()
    assert [g["lr"] for g in opt2.param_groups] == pytest.approx([1e-5, 1e-6])


RECIPES = {
    "adam_multistep": ["SOLVER.LR_STEPS", "(1,)", "SOLVER.DEPTH_LR", "1e-2", "SOLVER.POSE_LR", "3e-3"],
    "adamw_poly": ["SOLVER.OPT", "adamw_poly", "SOLVER.DEPTH_LR", "1e-2", "SOLVER.WEIGHT_DECAY", "0.1",
                   "SOLVER.MAX_EPOCHS", "2"],
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_three_updates_match_optax(recipe, rng):
    """steps_per_epoch = 2, so adam_multistep's rate drops before the third
    update and the poly rate decays at each: the schedule's phase (the rate read
    at the count before the update) is part of what is compared."""
    cfg_j, cfg_t = _cfgs(RECIPES[recipe])
    model = _Tiny(rng)
    params = _as_tree(model)
    tx, _ = jsolver.build_optimizer(cfg_j, 2)
    opt_state = tx.init(params)
    opt, sched = build_optimizer(cfg_t, model, 2)
    names = [n for n, _ in model.named_parameters()]
    for _ in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in model.named_parameters()}
        g_tree = jax.tree_util.tree_map(jnp.zeros_like, params)
        for n in names:
            node = g_tree
            *parents, leaf = n.split(".")
            for part in parents:
                node = node[part]
            node[leaf] = jnp.asarray(grads[n])
        updates, opt_state = tx.update(g_tree, opt_state, params)
        params = optax.apply_updates(params, updates)

        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        opt.step()
        sched.step()
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), _leaf(params, n), atol=1e-6, rtol=0, err_msg=n)


# --- BtsModel's frozen parameters and TPU.REMAT ---

FREEZE_CASES = {
    "resnet50_bts": ("bts_r50.yaml", []),
    "resnet50_bts-FIX_1ST_CONV": ("bts_r50.yaml", ["MODEL.DEPTH_NET.FIX_1ST_CONV", "True"]),
    "resnet50_bts-FIX_1ST_CONVS": ("bts_r50.yaml", ["MODEL.DEPTH_NET.FIX_1ST_CONVS", "True"]),
    "densenet121_bts": ("bts_r50.yaml", ["MODEL.DEPTH_NET.ENCODER_NAME", "densenet121_bts"]),
    "mobilenetv2_bts": ("bts_r50.yaml", ["MODEL.DEPTH_NET.ENCODER_NAME", "mobilenetv2_bts"]),
    "DepthResNet": ("resnet18.yaml", []),
}


def _jax_frozen_tree(cfg_j, params):
    """1.0 where the JAX package's optimizer (``apply_freeze`` around a plain
    SGD step) leaves a parameter unmoved, 0.0 where it moves it."""
    tx = jsolver.apply_freeze(optax.sgd(1.0), jsolver.freeze_substrings_from_cfg(cfg_j))

    @jax.jit
    def updates_of_ones(p):
        return tx.update(jax.tree_util.tree_map(jnp.ones_like, p), tx.init(p), p)[0]

    updates = updates_of_ones(params)
    return jax.tree_util.tree_map(lambda u: np.full(u.shape, float(not np.any(np.asarray(u))), np.float32), updates)


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_freeze_rules_select_the_jax_packages_parameters(case):
    """The port's rules pick exactly the parameters the JAX package's rules pick,
    mapped through ``flax_import``'s names; the optimizer holds all the others."""
    from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
    from simpledepthestimation_tpu_torch.models import build_model
    from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict
    from simpledepthestimation_tpu_torch.solver import frozen_parameter_names

    from torch_port_helpers import reference_state_dict, supervised_cfgs

    yaml_name, extra = FREEZE_CASES[case]
    cfg_j, cfg_t = supervised_cfgs(yaml_name, ["MODEL.DEPTH_NET.BTS_SIZE", "128", *extra])
    model = build_model(cfg_t, device="cpu")
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    params, _ = convert_meta_arch(reference_state_dict(sd, cfg_j), cfg_j)
    marks = flax_to_state_dict(_jax_frozen_tree(cfg_j, params))
    assert set(marks) == {k for k, _ in model.named_parameters()}
    want = {k for k, m in marks.items() if m.all()}
    got = set(frozen_parameter_names(cfg_t, model))
    assert got == want, (sorted(got - want)[:5], sorted(want - got)[:5])
    if case.startswith("resnet50_bts"):
        # the stem conv and 49 BN pairs, not the 4 downsample BNs; FIX_1ST_CONV adds layer1.0's three
        # convs and its downsample (conv and BN pair), FIX_1ST_CONVS also layer1.1's three convs
        extra = {"resnet50_bts": 0, "resnet50_bts-FIX_1ST_CONV": 6, "resnet50_bts-FIX_1ST_CONVS": 9}[case]
        assert len(want) == 1 + 2 * 49 + extra
    else:
        assert bool(want) == case.startswith("densenet")
    optimizer, _ = build_optimizer(cfg_t, model, steps_per_epoch=1)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    assert {k for k, p in model.named_parameters() if id(p) not in held} == want


def test_frozen_parameters_get_no_weight_decay():
    """A frozen parameter is in no AdamW group; the rest of the encoder decays.
    (One step on the port and the JAX package's ``grad_norm``:
    ``tests/test_torch_bts.py``, where the JAX gradient is compiled anyway.)"""
    from simpledepthestimation_tpu_torch.parallel import create_train_state
    from simpledepthestimation_tpu_torch.solver import frozen_parameter_names

    from torch_port_helpers import supervised_cfgs

    _, cfg_t = supervised_cfgs("bts_r50.yaml", ["MODEL.DEPTH_NET.BTS_SIZE", "128"])
    state = create_train_state(cfg_t, device="cpu")
    frozen = set(frozen_parameter_names(cfg_t, state.model))
    names = {id(p): k for k, p in state.model.named_parameters()}
    groups = {g["name"]: (g["weight_decay"], {names[id(p)] for p in g["params"]}) for g in state.optimizer.param_groups}
    assert groups["encoder"][0] == 0.01 and groups["decoder"][0] == 0.0
    assert not frozen & (groups["encoder"][1] | groups["decoder"][1])
    assert groups["encoder"][1] | groups["decoder"][1] | frozen == set(names.values())
    assert all(k.startswith("depth_net.encoder.") for k in groups["encoder"][1])
    assert all(p.requires_grad for p in state.model.parameters())  # frozen is not requires_grad=False


def test_remat_changes_memory_not_math():
    """``TPU.REMAT`` recomputes the forward in the backward. From one state, one
    step with and one without give equal losses, gradients, parameters and
    running statistics (the recomputation's BatchNorms leave the statistics as
    the forward left them), and equal counters."""
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    from torch_port_helpers import batch_to_torch, make_sup_batch, supervised_cfgs

    _, cfg = supervised_cfgs("bts_r50.yaml", ["MODEL.DEPTH_NET.BTS_SIZE", "128", "TPU.COMPUTE_DTYPE", "float32"])
    batch = batch_to_torch(make_sup_batch(seed=4, B=2, H=64, W=96, flip=(False, True)))
    runs = []
    for remat in (False, True):
        state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
        metrics = make_train_step(state, remat=remat)(batch)
        grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        runs.append((metrics, grads, state.model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert set(s0) == set(s1) and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(int(s1[k]) == 1 for k in s1 if k.endswith("num_batches_tracked"))


def test_remat_replays_the_training_noise():
    """MotionLearning's RandLayerNorm draws noise from the state's generator: the
    recomputation replays the same draws, and the generator ends where the step
    without REMAT leaves it."""
    from simpledepthestimation_tpu_torch.config import get_cfg
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    from torch_port_helpers import REPO

    cfg = get_cfg()
    cfg.merge_from_file(f"{REPO}/projects/MotionLearning/configs/resnet18.yaml")
    cfg.merge_from_list(["MODEL.DEPTH_NET.ENCODER_NAME", "18", "TPU.COMPUTE_DTYPE", "float32"])
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(2, 3, 32, 64).astype(np.float32))
    batch = {"img": img, "ctx_img": torch.roll(img, 2, dims=3)[:, None].contiguous(),
             "intrinsics": torch.tensor([[[37.0, 0, 32], [0, 61, 16], [0, 0, 1]]]).repeat(2, 1, 1),
             "flip": torch.tensor([False, True])}
    schedule = lambda i: {"noise_stddev": 0.5, "motion_weight": 1.0}  # noqa: E731
    runs = []
    for remat in (False, True):
        state = create_train_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0), steps_per_epoch=4)
        metrics = make_train_step(state, schedule_fn=schedule, remat=remat)(batch)
        runs.append((metrics, {k: p.grad.clone() for k, p in state.model.named_parameters() if p.grad is not None},
                     state.noise_generator.get_state()))
    (m0, g0, n0), (m1, g1, n1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert set(g0) == set(g1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(n0, n1)
