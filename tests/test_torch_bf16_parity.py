"""bfloat16, the dtype every shipped yaml selects: the port vs the JAX package on the CPU.

``TPU.COMPUTE_DTYPE bfloat16`` on both sides, everything else as the float32
slice tests have it: MonoDepth2-R18 at B=2, 64x256, N=2 (``test_torch_monodepth2.py``'s
batch) and MotionLearning-R18 at B=2, 64x96 on batch seed 3, noise 0, motion
weight 1 (``test_torch_motionlearning.py``'s). Weights: the port's seeded init,
carried to the JAX model by the JAX package's ``convert_meta_arch``, perturbed
with numpy and loaded back with ``load_flax_variables``, so both sides start
from the same float32 values. The JAX function is compiled once per model.

Both packages round to bfloat16 at the places the JAX package's source names:
each convolution's input, kernel and bias, its result, and the bias added to
that result; norms, geometry and losses stay float32. XLA on the CPU by default
drops a float32 -> bfloat16 -> float32 round trip (``xla_allow_excess_precision``),
so the norm after a convolution would see the unrounded sum; the JAX function
here is compiled with that option off, so that it rounds where its source says.

Where both round at the same places, the two sides differ only where a sum
taken in another order rounds to the neighbouring bfloat16 value, and more
than half of the depth map's pixels come out of the last convolution and its
sigmoid on the same bfloat16 value: the median per-pixel error of depth_pred
is one float32 rounding of ``disp_to_depth``. A port that computes in float32
lies off that grid at every pixel. So each model is checked three ways, and the
port run in float32 (the control) must fail the loss-dict and the median checks.

Measured on these batches (depth_pred per pixel, relative to its own value):
- MonoDepth2: losses 2.4e-4 (``smooth_loss``); depth largest 1.5e-2, mean
  2.1e-3, median 8.3e-8. The port in float32: losses 1.0e-3, depth 1.8e-2,
  3.1e-3, median 2.6e-3.
- MotionLearning: losses 5.8e-4 (``trans_loss``); depth 5.2e-3, 8.3e-4,
  median 1.0e-7. The port in float32: losses 2.8e-3, depth 1.2e-2, 1.7e-3,
  median 1.3e-3.
With the bias folded into the convolution (one rounding where flax rounds
twice, as the port had it on the CPU) MotionLearning's losses were 5.0e-3 and
its median 1.3e-3: both checks caught it.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.config import get_cfg as get_cfg_jax
from simpledepthestimation_tpu.models import build_model as build_model_jax
from simpledepthestimation_tpu.models.torch_import import convert_meta_arch
from simpledepthestimation_tpu_torch.config import get_cfg
from simpledepthestimation_tpu_torch.models import build_model
from simpledepthestimation_tpu_torch.models.flax_import import load_flax_variables

from torch_port_helpers import REPO, batch_to_torch, make_batch, nhwc, randomize_variables, smooth_field, to_numpy_tree

MONODEPTH2 = os.path.join(REPO, "projects", "MonoDepth2", "configs", "resnet18.yaml")
MOTION = os.path.join(REPO, "projects", "MotionLearning", "configs", "resnet18.yaml")

# per model: the loss dict (relative, per key), depth_pred per pixel (relative: largest, mean,
# median): about twice the errors measured (module docstring); the median's limit is a
# hundredth of the control's
LIMITS = {"MonoDepth2": (5e-4, 3e-2, 4e-3, 1e-5), "MotionLearning": (1.2e-3, 1e-2, 1.6e-3, 1e-5)}
# the JAX function rounds where its source says (module docstring)
ROUND_AS_WRITTEN = {"xla_allow_excess_precision": False}


def _cfgs(path, extra=()):
    """The shipped yaml as it stands (its ``"18pt"`` encoder builds; nothing here
    loads weights) in bfloat16, under both packages."""
    out = []
    for get in (get_cfg_jax, get_cfg):
        cfg = get()
        cfg.merge_from_file(path)
        cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "bfloat16", *extra])
        out.append(cfg)
    return tuple(out)


def _models(path):
    """(JAX model, port model, port model in float32, variables) on the same perturbed weights."""
    cfg_j, cfg_t = _cfgs(path)
    port = build_model(cfg_t, device="cpu", generator=torch.Generator().manual_seed(0))
    params, stats = convert_meta_arch(port.state_dict(), cfg_j)
    variables = randomize_variables(to_numpy_tree({"params": params, "batch_stats": stats}))
    load_flax_variables(port, variables["params"], variables.get("batch_stats"))
    if not stats:
        variables = {"params": variables["params"]}
    port_f32 = build_model(_cfgs(path, ["TPU.COMPUTE_DTYPE", "float32"])[1], device="cpu")
    port_f32.load_state_dict(port.state_dict())
    return build_model_jax(cfg_j), port, port_f32, variables


def _motion_batch(seed=3, B=2, H=64, W=96):
    rng = np.random.RandomState(seed)
    img = smooth_field(rng, B, H, W, 3)
    ctx = (np.roll(img, 2, axis=2)[:, None] + 0.01 * rng.rand(B, 1, H, W, 3)).astype(np.float32)
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    return {"img": img, "ctx_img": ctx, "intrinsics": K, "flip": np.array([False, True]),
            "noise_stddev": np.float32(0.0), "motion_weight": np.float32(1.0)}


@pytest.fixture(scope="module", params=["MonoDepth2", "MotionLearning"])
def outputs(request):
    """(model name, {run: (loss dict, depth_pred NHWC)}) as floats and numpy, for
    the JAX package in bfloat16 and the port in bfloat16 and in float32."""
    name = request.param
    if name == "MonoDepth2":
        path = MONODEPTH2
        batch = make_batch(seed=0, B=2, H=64, W=256, N=2, with_depth=True, flip=(False, True))
    else:
        path = MOTION
        batch = _motion_batch()
    model_j, port, port_f32, variables = _models(path)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"noise": jax.random.PRNGKey(0)}

    def both(v, b):
        losses, _ = model_j.apply(v, b, train=True, rngs=rngs, mutable=["batch_stats"])
        return losses, model_j.apply(v, b, train=False, rngs=rngs)["depth_pred"]

    losses, depth = jax.jit(both).lower(variables, jb).compile(compiler_options=ROUND_AS_WRITTEN)(variables, jb)
    out = {"jax_bf16": ({k: float(v) for k, v in losses.items()}, np.asarray(depth))}
    tb = batch_to_torch(batch)
    for key, model in (("port_bf16", port), ("port_f32", port_f32)):
        with torch.no_grad():
            depth = model(tb, train=False)["depth_pred"]  # before train=True moves the running statistics
            losses = model(tb, train=True, generator=torch.Generator().manual_seed(0))
        assert all(p.dtype == torch.float32 for p in model.parameters()) and depth.dtype == torch.float32
        out[key] = ({k: float(v) for k, v in losses.items()}, nhwc(depth))
    return name, out


def _loss_err(a, b):
    return max(abs(a[k] - b[k]) / abs(b[k]) for k in b)


def _depth_err(a, b):
    """Per pixel, relative: largest, mean, median."""
    rel = np.abs(a - b) / np.abs(b)
    return float(rel.max()), float(rel.mean()), float(np.median(rel))


def test_bf16_loss_dict_matches_jax(outputs):
    name, out = outputs
    (port, _), (ref, _) = out["port_bf16"], out["jax_bf16"]
    assert set(port) == set(ref) and all(np.isfinite(v) for v in port.values())
    assert _loss_err(port, ref) <= LIMITS[name][0], {k: abs(port[k] - ref[k]) / abs(ref[k]) for k in ref}


def test_bf16_depth_pred_matches_jax(outputs):
    name, out = outputs
    (_, port), (_, ref) = out["port_bf16"], out["jax_bf16"]
    assert port.shape == ref.shape and np.isfinite(port).all()
    largest, mean, median = _depth_err(port, ref)
    assert largest <= LIMITS[name][1] and mean <= LIMITS[name][2] and median <= LIMITS[name][3], \
        (largest, mean, median)


def test_float32_port_fails_the_bf16_checks(outputs):
    """The control: the port computing in float32, on the same weights and
    batch, lies outside the loss dict's limit and the median's."""
    name, out = outputs
    (port, depth), (ref, ref_depth) = out["port_f32"], out["jax_bf16"]
    assert _loss_err(port, ref) > LIMITS[name][0]
    assert _depth_err(depth, ref_depth)[2] > LIMITS[name][3]
