"""BtsModel (``resnet50_bts``): the port vs the JAX package on the CPU.

``projects/Supervised/configs/bts_r50.yaml`` (SupDepthModel, ``DATASET kitti``)
at ``BTS_SIZE`` 128, the smallest width that keeps ``reduc1x1``'s chain
(nf/32 ≥ 4), in float32, at B=2, 224x320: H/8 = 28 > 24, so the dilation-24
branch of the dense ASPP reads real pixels, not only padding. The batch has
per-sample focal lengths (the KITTI focal scaling), one flipped sample, and
ground truth with a third of its pixels ≤ 1 (outside ``silog_loss``'s mask).

Weights: the port's seeded init, carried to the JAX tree by the JAX package's
``convert_meta_arch`` (no JAX ``init``), perturbed with numpy and loaded back
with ``load_flax_variables``. One jitted JAX function gives the eval depth,
the train-mode loss, its gradient, the running statistics after the step and
the ``BN_NO_TRACK`` loss and gradient. bfloat16: ``tests/test_torch_bts_bf16.py``.

Measured on an 8-core Intel Xeon CPU, limits beside:
- float32 depth per pixel 2.9e-6 (1e-4), losses 4.4e-7 (1e-5), running
  statistics after the step 1.4e-7 of each tensor's largest (1e-5).
- The gradient with train-mode BatchNorms is ill-conditioned in float32: each
  BatchNorm's backward subtracts the gradient's projection on its batch
  statistics, and a large projection leaves a small difference. Against the
  port run in float64, the port's float32 gradient is off by up to 15 % per
  tensor (median 1.1e-2) and the JAX package's by 17 % (median 1.9e-2), worst
  in layer4, whose gradient is 1e-5 of layer3's. So per-tensor maxima say
  nothing there, and the check is the one the JAX package holds its own BTS
  gradient to (``tests/test_reference_grad_parity.py``): the flattened
  gradient's 1 − cosine 2.3e-5 (1e-4) and relative L2 6.7e-3 (2e-2), the
  per-tensor median 1.8e-2 (5e-2), the global norm 8.0e-5 (3e-4).
- With ``BN_NO_TRACK`` (no batch statistics) every tensor is held: per tensor
  ``max|Δ| / max|g|`` 2.1e-3 at most (5e-3, layer3.3.conv3), median 5.4e-5
  (2e-4), 1 − cosine 5.7e-10 (1e-8).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu.models.bts import local_planar_guidance as jax_lpg
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.bts import BtsModel, local_planar_guidance
from simpledepthestimation_tpu_torch.models.flax_import import flax_to_state_dict, load_flax_variables
from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step
from simpledepthestimation_tpu_torch.solver import frozen_parameter_names

from torch_port_helpers import batch_to_torch, make_sup_batch, nhwc, shared_variables, supervised_cfgs

B, H, W = 2, 224, 320
OVERRIDES = ["MODEL.DEPTH_NET.BTS_SIZE", "128"]
NO_TRACK = ["MODEL.DEPTH_NET.BN_NO_TRACK", "True"]
# the limits and what they were set from: module docstring
DEPTH_RTOL, LOSS_RTOL, STATS_RTOL = 1e-4, 1e-5, 1e-5
GRAD_ONE_MINUS_COS, GRAD_REL_L2, GRAD_MEDIAN, NORM_RTOL = 1e-4, 2e-2, 5e-2, 3e-4
NT_GRAD_RTOL, NT_GRAD_MEDIAN, NT_ONE_MINUS_COS = 5e-3, 2e-4, 1e-8


def _cfgs(dtype="float32", extra=()):
    return supervised_cfgs("bts_r50.yaml", OVERRIDES + ["TPU.COMPUTE_DTYPE", dtype, *extra])


def _port_grads(model, tb):
    """(train-mode loss, {name: gradient}) of the port, from zeroed gradients."""
    model.zero_grad(set_to_none=True)
    loss = model(tb, train=True)["silog_loss"]
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def run():
    """Both sides' results on one set of weights and one batch: eval depth,
    train-mode loss, gradient and statistics after the step; the same loss and
    gradient with ``BN_NO_TRACK``."""
    cfg_j, cfg_t = _cfgs()
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    variables = shared_variables(port, cfg_j)
    batch = make_sup_batch(seed=5, B=B, H=H, W=W, flip=(False, True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model_j = build_model_jax(cfg_j)
    model_nt = build_model_jax(_cfgs(extra=NO_TRACK)[0])

    def jax_fn(v, b):
        depth = model_j.apply(v, b, train=False)["depth_pred"]

        def loss_fn(p, model):
            out, new = model.apply({"params": p, "batch_stats": v["batch_stats"]}, b, train=True,
                                   mutable=["batch_stats"])
            return out["silog_loss"], new["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"], model_j)
        (nt_loss, nt_stats), nt_grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"], model_nt)
        # the JAX package's train step reports optax.global_norm over every gradient
        return depth, loss, grads, optax.global_norm(grads), stats, nt_loss, nt_grads

    depth, loss, grads, grad_norm, stats, nt_loss, nt_grads = jax.jit(jax_fn)(variables, jb)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    ref = {"depth": np.asarray(depth), "loss": float(loss), "grad_norm": float(grad_norm),
           "grads": flax_to_state_dict(as_np(grads)),
           "stats": flax_to_state_dict(variables["params"], as_np(stats)),
           "nt_loss": float(nt_loss), "nt_grads": flax_to_state_dict(as_np(nt_grads))}

    tb = batch_to_torch(batch)
    with torch.no_grad():
        depth_t = port(tb, train=False)["depth_pred"]
    loss_t, grads_t = _port_grads(port, tb)
    got = {"depth": nhwc(depth_t), "loss": loss_t, "grads": grads_t,
           "stats": {k: v.numpy() for k, v in port.state_dict().items() if "running" in k}}
    port_nt = build_model(_cfgs(extra=NO_TRACK)[1], device="cpu")
    load_flax_variables(port_nt, variables["params"], variables["batch_stats"])
    before = {k: v.clone() for k, v in port_nt.state_dict().items()}
    got["nt_loss"], got["nt_grads"] = _port_grads(port_nt, tb)
    got["nt_stats_kept"] = all(torch.equal(v, before[k]) for k, v in port_nt.state_dict().items())
    return variables, batch, ref, got


def test_eval_depth_matches_jax(run):
    *_, ref, got = run
    assert got["depth"].shape == (B, H, W, 1) and np.isfinite(got["depth"]).all()
    err = np.abs(got["depth"] - ref["depth"]) / np.abs(ref["depth"])
    assert err.max() <= DEPTH_RTOL, err.max()


def test_train_loss_matches_jax(run):
    *_, ref, got = run
    assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]), (got["loss"], ref["loss"])


def test_parameter_gradients_match_jax(run):
    """Train-mode BatchNorms: the float32 gradient of this net is itself far from
    the exact one (module docstring), so per-tensor maxima say nothing; held,
    as the JAX package holds its own BTS gradient against the original code:
    the flattened gradient's direction and size, the per-tensor median, the
    global norm, and no tensor without a gradient."""
    *_, ref, got = run
    errs, one_minus_cos, rel_l2 = _grad_errs(got["grads"], ref["grads"])
    median = float(np.median(list(errs.values())))
    assert one_minus_cos <= GRAD_ONE_MINUS_COS and rel_l2 <= GRAD_REL_L2 and median <= GRAD_MEDIAN, \
        (one_minus_cos, rel_l2, median)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in got["grads"].values()))
    norm_ref = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref["grads"].values()))
    assert abs(norm - norm_ref) <= NORM_RTOL * norm_ref
    # every parameter reaches the loss: the dilation-24 branch and the focal scaling included
    assert all(np.abs(g).max() > 0 for g in got["grads"].values())


def test_train_step_keeps_frozen_parameters_while_grad_norm_counts_them(run):
    """One step of the port's train step (``adamw_poly``, the BTS freeze rules)
    from the shared weights: ``grad_norm`` is the JAX package's
    (``optax.global_norm`` over every gradient, the frozen ones' included; the
    limit of the global norm above), the frozen parameters are unchanged to the
    bit and every other one moved. That the JAX package's optimizer freezes the
    same parameters: ``tests/test_torch_solver.py``."""
    variables, batch, ref, _ = run
    state = create_train_state(_cfgs()[1], device="cpu", steps_per_epoch=4)
    load_flax_variables(state.model, variables["params"], variables["batch_stats"])
    start = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    metrics = make_train_step(state)(batch_to_torch(batch))
    frozen = set(frozen_parameter_names(_cfgs()[1], state.model))
    assert len(frozen) == 99  # the stem conv and 49 BN pairs
    assert abs(float(metrics["grad_norm"]) - ref["grad_norm"]) <= NORM_RTOL * ref["grad_norm"]
    without = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for k, g in ref["grads"].items() if k not in frozen))
    assert abs(without - ref["grad_norm"]) > 10 * NORM_RTOL * ref["grad_norm"]  # the frozen gradients count
    for k, p in state.model.named_parameters():
        assert torch.equal(p.detach(), start[k]) == (k in frozen), k


def test_running_statistics_after_one_step_match_jax(run):
    *_, ref, got = run
    stats = {k: v for k, v in ref["stats"].items() if "running" in k}
    assert set(got["stats"]) == set(stats) and len(stats) > 100
    errs = {k: np.abs(v - stats[k]).max() / np.abs(stats[k]).max() for k, v in got["stats"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STATS_RTOL, (worst, errs[worst])


def _grad_errs(got, ref):
    """Per tensor ``max|Δ| / max|g|``, and the flattened gradients' 1 − cosine and relative L2."""
    assert set(got) == set(ref)
    errs = {k: float(np.abs(g - ref[k]).max() / np.abs(ref[k]).max()) for k, g in got.items()}
    va = np.concatenate([got[k].ravel() for k in sorted(ref)]).astype(np.float64)
    vb = np.concatenate([ref[k].ravel() for k in sorted(ref)]).astype(np.float64)
    return errs, 1.0 - va @ vb / np.linalg.norm(va) / np.linalg.norm(vb), np.linalg.norm(va - vb) / np.linalg.norm(vb)


def test_bn_no_track_matches_jax_and_keeps_the_statistics(run):
    """``BN_NO_TRACK``: in training the BatchNorms normalise with their running
    statistics and leave them alone. Without the batch statistics' projection
    the float32 gradient is well conditioned, so every tensor is held."""
    *_, ref, got = run
    assert abs(got["nt_loss"] - ref["nt_loss"]) <= LOSS_RTOL * abs(ref["nt_loss"]), (got["nt_loss"], ref["nt_loss"])
    assert abs(got["nt_loss"] - ref["loss"]) > 1e-3 * abs(ref["loss"])  # batch statistics give another loss
    assert got["nt_stats_kept"]
    errs, one_minus_cos, rel_l2 = _grad_errs(got["nt_grads"], ref["nt_grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= NT_GRAD_RTOL, (worst, errs[worst])
    assert np.median(list(errs.values())) <= NT_GRAD_MEDIAN and one_minus_cos <= NT_ONE_MINUS_COS


@pytest.mark.parametrize("r", [2, 4, 8])
def test_local_planar_guidance_matches_jax(r):
    rng = np.random.RandomState(r)
    plane = rng.randn(2, 5, 7, 4).astype(np.float32)
    plane[..., 2] = 2.0 + rng.rand(2, 5, 7)  # keep the denominator away from 0
    ref = np.asarray(jax_lpg(jnp.asarray(plane), r))
    got = local_planar_guidance(torch.from_numpy(plane.transpose(0, 3, 1, 2).copy()), r).numpy()
    assert got.shape == (2, 5 * r, 7 * r)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_local_planar_guidance_planar_exactness():
    """A fronto-parallel plane (n = (0, 0, 1), dist d) gives depth d at every subpixel."""
    plane = torch.zeros(1, 4, 4, 6)
    plane[:, 2] = 1.0
    plane[:, 3] = 7.5
    out = local_planar_guidance(plane, 4)
    assert out.shape == (1, 16, 24)
    assert torch.equal(out, torch.full_like(out, 7.5))


def test_registered_and_built_from_the_shipped_yaml():
    _, cfg = supervised_cfgs("bts_r50.yaml")
    model = build_model(cfg, device="cpu")
    net = model.depth_net
    assert isinstance(net, BtsModel) and net.encoder_name == "resnet50_bts"
    assert net.decoder.dataset == "kitti" and net.decoder.bn5.num_features == 512
    assert net.decoder.bn5.momentum == 0.01 and net.decoder.bn5.eps == 1.1e-5
    seq = net.decoder.daspp_6.atrous_conv
    assert seq["first_bn"].eps == 1.1e-5 and seq["aconv_sequence"]["2"].eps == 1e-5
    assert net.encoder.encoder.bn1.momentum == 0.1 and net.encoder.encoder.bn1.eps == 1e-5
    assert net.decoder.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_eval_step_reads_the_focal_length():
    """``DATASET kitti``: the evaluation's depth scales with ``intrinsics[:, 0, 0]``
    (the test loaders pass the intrinsics through ``do_test``'s eval step), and
    is the depth of focal 715.0873 without them."""
    from simpledepthestimation_tpu_torch.parallel import make_eval_step

    state = create_train_state(_cfgs()[1], device="cpu", generator=torch.Generator().manual_seed(1))
    batch = batch_to_torch(make_sup_batch(seed=2, B=2, H=64, W=96))
    depth = make_eval_step(state)(batch)
    doubled = make_eval_step(state)({**batch, "intrinsics": batch["intrinsics"] * torch.tensor([2.0, 1, 1])[:, None]})
    torch.testing.assert_close(doubled, 2 * depth, rtol=1e-6, atol=0)
    plain = make_eval_step(state)({k: v for k, v in batch.items() if k != "intrinsics"})
    focal = batch["intrinsics"][:, 0, 0].reshape(-1, 1, 1, 1)
    torch.testing.assert_close(depth, plain * focal / 715.0873, rtol=1e-6, atol=0)
