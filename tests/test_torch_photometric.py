"""The port's plain photometric map vs the JAX package on the CPU.

Same numpy inputs on both sides, float32. Tolerance 1e-6 absolute: the same
formula with the nine-term window sums taken in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpledepthestimation_tpu.ops import pallas_photometric as jp
from simpledepthestimation_tpu_torch.ops.photometric import photometric_map, photometric_map_plain

from torch_port_helpers import nchw, nhwc

ALPHA, C1, C2 = 0.85, 1e-4, 9e-4
SHAPES = [(2, 16, 128, 3), (1, 37, 83, 3), (2, 8, 24, 1), (1, 2, 2, 3)]


def _pair(rng, shape):
    a = rng.rand(*shape).astype(np.float32)
    b = (0.7 * a + 0.3 * rng.rand(*shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_map_matches_jax_reference(shape, rng):
    a, b = _pair(rng, shape)
    ref = np.asarray(jp.photometric_map_reference(jnp.asarray(a), jnp.asarray(b), ALPHA, C1, C2))
    out = photometric_map_plain(nchw(a), nchw(b), ALPHA, C1, C2)
    assert out.shape == (shape[0], 1, shape[1], shape[2])
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)
    assert torch.equal(out, photometric_map(nchw(a), nchw(b), ALPHA, C1, C2))


@pytest.mark.parametrize("shape", [(2, 16, 128, 3), (1, 19, 45, 3)], ids=["aligned", "unaligned"])
def test_plain_map_matches_pallas_kernel_interpret(shape, rng):
    a, b = _pair(rng, shape)
    ref = np.asarray(jp._pallas_forward(jnp.asarray(a), jnp.asarray(b), ALPHA, C1, C2, interpret=True))
    out = photometric_map_plain(nchw(a), nchw(b), ALPHA, C1, C2)
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_alpha_and_constants_are_arguments(alpha, rng):
    a, b = _pair(rng, (1, 9, 11, 3))
    ref = np.asarray(jp.photometric_map_reference(jnp.asarray(a), jnp.asarray(b), alpha, 1e-3, 4e-3))
    out = photometric_map(nchw(a), nchw(b), alpha, 1e-3, 4e-3)
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)


def test_plain_map_autograd_matches_jax_vjp(rng):
    """What the backward kernel of the training slice will be held against."""
    a, b = _pair(rng, (2, 10, 14, 3))
    g = rng.randn(2, 10, 14, 1).astype(np.float32)
    ga, gb = (np.asarray(t) for t in jp.photometric_vjp_reference(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(g), ALPHA, C1, C2))
    ta, tb = nchw(a).requires_grad_(), nchw(b).requires_grad_()
    photometric_map(ta, tb, ALPHA, C1, C2).backward(nchw(g))
    np.testing.assert_allclose(nhwc(ta.grad), ga, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(nhwc(tb.grad), gb, atol=2e-5, rtol=1e-4)


def test_bfloat16_inputs_give_float32_map(rng):
    a, b = _pair(rng, (1, 8, 12, 3))
    ta, tb = nchw(a).bfloat16(), nchw(b).bfloat16()
    out = photometric_map(ta, tb, ALPHA, C1, C2)
    assert out.dtype == torch.float32
    assert torch.equal(out, photometric_map_plain(ta.float(), tb.float(), ALPHA, C1, C2))
