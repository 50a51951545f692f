"""The port's ops/pool.py and models/losses.py vs the JAX package on the CPU:
same numpy inputs, float32, tolerance 1e-6 relative-or-absolute unless a test
says otherwise (reductions over many terms in another order: 1e-5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpledepthestimation_tpu.models import losses as jl
from simpledepthestimation_tpu.ops import pool as jpool
from simpledepthestimation_tpu_torch.models import losses as tl
from simpledepthestimation_tpu_torch.ops import pool as tpool

from torch_port_helpers import nchw, nhwc

SHAPE = (2, 13, 22, 3)


def _cmp(t_out, j_out, tol=1e-6):
    t_np = nhwc(t_out) if t_out.dim() == 4 else t_out.detach().numpy()
    np.testing.assert_allclose(t_np, np.asarray(j_out), atol=tol, rtol=tol)


def test_reflect_pad_and_3x3_pools(rng):
    x = rng.rand(*SHAPE).astype(np.float32)
    _cmp(tpool.reflect_pad_hw(nchw(x), 1), jpool.reflect_pad_hw(jnp.asarray(x), 1))
    _cmp(tpool.reflect_pad_hw(nchw(x), 2), jpool.reflect_pad_hw(jnp.asarray(x), 2))
    _cmp(tpool.avg_pool_3x3_reflect(nchw(x)), jpool.avg_pool_3x3_reflect(jnp.asarray(x)))
    _cmp(tpool.avg_pool_3x3_same(nchw(x)), jpool.avg_pool_3x3_same(jnp.asarray(x)))


@pytest.mark.parametrize("window,stride,padding", [(2, 2, "VALID"), (3, 1, "VALID"), (3, 2, "SAME"), (2, 1, "SAME")])
def test_avg_and_max_pool(window, stride, padding, rng):
    x = rng.randn(*SHAPE).astype(np.float32)
    _cmp(tpool.avg_pool(nchw(x), window, stride, padding), jpool.avg_pool(jnp.asarray(x), window, stride, padding))
    _cmp(tpool.max_pool(nchw(x), window, stride, padding), jpool.max_pool(jnp.asarray(x), window, stride, padding), tol=0)


def test_masked_mean(rng):
    x = rng.randn(*SHAPE).astype(np.float32)
    m = rng.rand(*SHAPE) < 0.3
    _cmp(tl.masked_mean(nchw(x), nchw(m)), jl.masked_mean(jnp.asarray(x), jnp.asarray(m)))
    assert tl.masked_mean(nchw(x), torch.zeros(SHAPE[0], 3, *SHAPE[1:3], dtype=torch.bool)) == 0
    # per-sample reduction
    out = tl.masked_mean(nchw(x), nchw(m), dim=(1, 2, 3))
    ref = jl.masked_mean(jnp.asarray(x), jnp.asarray(m), axis=(1, 2, 3))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_silog_and_variance(rng):
    est = (0.5 + 40 * rng.rand(2, 13, 22, 1)).astype(np.float32)
    gt = (60 * rng.rand(2, 13, 22, 1)).astype(np.float32)  # some below the gt > 1 mask
    _cmp(tl.silog_loss(nchw(est), nchw(gt), 0.85), jl.silog_loss(jnp.asarray(est), jnp.asarray(gt), 0.85), tol=1e-5)
    _cmp(tl.silog_loss(nchw(est), nchw(gt), 0.5), jl.silog_loss(jnp.asarray(est), jnp.asarray(gt), 0.5), tol=1e-5)
    # variance_loss is a plain mean of squares (no ddof): the two agree as they stand
    _cmp(tl.variance_loss(nchw(est)), jl.variance_loss(jnp.asarray(est)), tol=1e-5)


def test_ssim(rng):
    x = rng.rand(*SHAPE).astype(np.float32)
    y = (0.6 * x + 0.4 * rng.rand(*SHAPE)).astype(np.float32)
    _cmp(tl.ssim(nchw(x), nchw(y)), jl.ssim(jnp.asarray(x), jnp.asarray(y)), tol=2e-6)
    _cmp(tl.ssim(nchw(x), nchw(y), 1e-3, 5e-3), jl.ssim(jnp.asarray(x), jnp.asarray(y), 1e-3, 5e-3), tol=2e-6)


@pytest.mark.parametrize("ssim_weight,clip", [(0.85, 0.0), (0.0, 0.0), (0.85, 0.5), (0.15, 2.0)])
def test_photometric_loss(ssim_weight, clip, rng):
    """clip > 0 exercises the unbiased std (torch default == ddof=1 on the JAX side)."""
    x = rng.rand(*SHAPE).astype(np.float32)
    y = (0.6 * x + 0.4 * rng.rand(*SHAPE)).astype(np.float32)
    out = tl.photometric_loss(nchw(x), nchw(y), ssim_weight, clip=clip)
    ref = jl.photometric_loss(jnp.asarray(x), jnp.asarray(y), ssim_weight, clip=clip)
    _cmp(out, ref, tol=2e-6)
    if clip > 0:
        assert (np.asarray(ref) == np.asarray(ref).max()).sum() > 1  # the cap really cut


@pytest.mark.parametrize("reversed_", [False, True])
def test_gradients_and_smoothness(reversed_, rng):
    img = rng.rand(*SHAPE).astype(np.float32)
    depth = (0.5 + 30 * rng.rand(2, 13, 22, 1)).astype(np.float32)
    _cmp(tl.gradient_x(nchw(img), reversed_), jl.gradient_x(jnp.asarray(img), reversed_), tol=0)
    _cmp(tl.gradient_y(nchw(img), reversed_), jl.gradient_y(jnp.asarray(img), reversed_), tol=0)
    _cmp(tl.smoothness_loss(nchw(depth), nchw(img), reversed_),
         jl.smoothness_loss(jnp.asarray(depth), jnp.asarray(img), reversed_), tol=1e-5)
