"""The slice as a whole: the port's MonoDepth2Model vs ``model.apply`` of the
JAX model on the CPU, on shared weights and one shared batch (B=2, 64x256,
N=2, float32).

Weights: the port's seeded init carried to a Flax tree by the JAX package's
``convert_meta_arch`` (no JAX ``init`` compile), perturbed with numpy, carried
back by ``load_flax_variables``. Every entry of the loss dict (``train=True``) and
``depth_pred`` (``train=False``) agree to 1e-4 relative: two ResNet-18 sized
stacks of float32 convolutions summed in another order, then a projection that
cancels K against its inverse.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables
from simpledepthestimation_tpu_torch.ops.photometric import photometric_map
from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear

from torch_port_helpers import batch_to_torch, make_batch, monodepth2_cfgs, nhwc, shared_variables

RTOL = 1e-4


@pytest.fixture(scope="module")
def shared():
    cfg_j, cfg_t = monodepth2_cfgs()
    batch = make_batch(seed=0, B=2, H=64, W=256, N=2, with_depth=True, flip=(False, True))
    variables = shared_variables(build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0)), cfg_j)
    return batch, variables


def _both(overrides, shared):
    batch, variables = shared
    cfg_j, cfg_t = monodepth2_cfgs(overrides)
    model_j = build_model_jax(cfg_j)
    model_t = build_model(cfg_t, device="cpu")
    load_flax_variables(model_t, variables["params"], variables["batch_stats"])
    return model_j, model_t, {k: jnp.asarray(v) for k, v in batch.items()}, batch_to_torch(batch), variables


CASES = {
    "config-default": [],
    "no-automask": ["LOSS.AUTOMASK", "False"],
    "mean-reduce": ["LOSS.PHOTOMETRIC_REDUCE", "mean"],
    "clip": ["LOSS.CLIP", "0.5"],
    "clip-no-automask-mean": ["LOSS.CLIP", "1.0", "LOSS.AUTOMASK", "False", "LOSS.PHOTOMETRIC_REDUCE", "mean"],
    "no-automask-mean": ["LOSS.AUTOMASK", "False", "LOSS.PHOTOMETRIC_REDUCE", "mean"],
    "clip-mean": ["LOSS.CLIP", "0.5", "LOSS.PHOTOMETRIC_REDUCE", "mean"],
    "clip-no-automask": ["LOSS.CLIP", "0.5", "LOSS.AUTOMASK", "False"],
    "sup-and-var-terms": ["LOSS.SUPERVISED_WEIGHT", "0.1", "LOSS.VAR_LOSS_WEIGHT", "0.01"],
    "l1-only": ["LOSS.SSIM_WEIGHT", "0.0"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_dict_matches_jax(case, shared):
    model_j, model_t, jb, tb, variables = _both(CASES[case], shared)
    ref, _ = model_j.apply(variables, jb, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        out = model_t(tb, train=True)
    assert set(out) == set(ref)
    assert {"rec_loss", "smooth_loss"} <= set(out)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=RTOL, atol=0, err_msg=k)


def test_depth_pred_matches_jax(shared):
    model_j, model_t, jb, tb, variables = _both([], shared)
    ref = model_j.apply(variables, jb, train=False)["depth_pred"]
    with torch.no_grad():
        out = model_t(tb, train=False)
    assert set(out) == {"depth_pred"}
    assert out["depth_pred"].shape == (2, 1, 64, 256)
    np.testing.assert_allclose(nhwc(out["depth_pred"]), np.asarray(ref), rtol=RTOL, atol=0)


def test_cpu_forward_differentiates_and_launches_no_kernel(shared):
    """On the CPU the wrappers take their plain versions, which autograd
    differentiates as they stand: every parameter of both nets gets a gradient.
    (Automask off: on this batch the identity maps win the min everywhere, which
    would cut the pose net off from the loss.)"""
    _, model_t, _, tb, _ = _both(["LOSS.AUTOMASK", "False"], shared)
    before = (warp_bilinear.launches, photometric_map.launches)
    losses = model_t(tb, train=True)
    sum(losses.values()).backward()
    assert (warp_bilinear.launches, photometric_map.launches) == before
    grads = [p.grad for p in model_t.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(float(g.abs().sum()) > 0 for g in grads) > 0.9 * len(grads)


def test_sup_depth_model_matches_jax(shared):
    """The supervised meta-architecture shares the depth net and the silog loss."""
    batch, variables = shared
    cfg_j, cfg_t = monodepth2_cfgs(["MODEL.META_ARCHITECTURE", "SupDepthModel"])
    model_j, model_t = build_model_jax(cfg_j), build_model(cfg_t, device="cpu")
    v = {"params": {"depth_net": variables["params"]["depth_net"]},
         "batch_stats": {"depth_net": variables["batch_stats"]["depth_net"]}}
    load_flax_variables(model_t, v["params"], v["batch_stats"])
    jb = {k: jnp.asarray(b) for k, b in batch.items()}
    pred = model_j.apply(v, jb, train=False)["depth_pred"]
    ref, _ = model_j.apply(v, jb, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        out_pred = model_t(batch_to_torch(batch), train=False)["depth_pred"]
        out = model_t(batch_to_torch(batch), train=True)
    np.testing.assert_allclose(nhwc(out_pred), np.asarray(pred), rtol=RTOL, atol=0)
    assert set(out) == set(ref) == {"silog_loss"}
    np.testing.assert_allclose(float(out["silog_loss"]), float(ref["silog_loss"]), rtol=RTOL)
