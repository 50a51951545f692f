"""The port's plain photometric map vs the JAX package on the CPU.

Same numpy inputs on both sides, float32. Tolerance 1e-6 absolute: the same
formula with the nine-term window sums taken in another order."""

import numpy as np
import pytest
import torch

import jax
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


# --- the analytic VJP (what the backward kernel computes) --------------------

from simpledepthestimation_tpu_torch.ops.photometric import photometric_vjp, photometric_vjp_plain  # noqa: E402
from simpledepthestimation_tpu_torch.ops.pool import avg_pool_3x3_reflect, pool9_adjoint  # noqa: E402

VJP_SHAPES = [(2, 2, 2, 3), (1, 2, 5, 1), (2, 3, 3, 3), (1, 37, 83, 3), (2, 64, 96, 3), (1, 4, 4, 1)]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("alpha", [0.0, 0.85, 1.0])
@pytest.mark.parametrize("shape", VJP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vjp_plain_matches_jax(shape, alpha, rng):
    """``photometric_vjp_plain`` vs the JAX package: ≤1e-5 of ``max|g_a|``. Where
    both plane sides are ≥ 4 the oracle is ``photometric_vjp_reference``; its
    pooling adjoint slices rows 1 and H−2 apart and does not take smaller planes,
    so there the oracle is ``jax.vjp`` of ``photometric_map_reference`` (random
    inputs, no ties)."""
    a, b = _pair(rng, shape)
    g = rng.randn(*shape[:3], 1).astype(np.float32)
    ja, jb, jg = jnp.asarray(a), jnp.asarray(b), jnp.asarray(g)
    if min(shape[1:3]) >= 4:
        ga, gb = jp.photometric_vjp_reference(ja, jb, jg, alpha, C1, C2)
    else:
        _, vjp = jax.vjp(lambda p, q: jp.photometric_map_reference(p, q, alpha, C1, C2), ja, jb)
        ga, gb = vjp(jg)
    ta, tb = photometric_vjp_plain(nchw(a), nchw(b), nchw(g), alpha, C1, C2)
    assert ta.shape == tb.shape == nchw(a).shape
    assert _rel_err(nhwc(ta), np.asarray(ga)) <= 1e-5
    assert _rel_err(nhwc(tb), np.asarray(gb)) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 16, 128, 3), (1, 19, 45, 3)], ids=["aligned", "unaligned"])
def test_vjp_plain_matches_pallas_backward_kernel_interpret(shape, rng):
    a, b = _pair(rng, shape)
    g = rng.randn(*shape[:3], 1).astype(np.float32)
    ga, gb = jp._pallas_backward(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g), ALPHA, C1, C2, interpret=True)
    ta, tb = photometric_vjp_plain(nchw(a), nchw(b), nchw(g), ALPHA, C1, C2)
    assert _rel_err(nhwc(ta), np.asarray(ga)) <= 1e-5
    assert _rel_err(nhwc(tb), np.asarray(gb)) <= 1e-5


@pytest.mark.parametrize("hw", [(2, 2), (2, 5), (3, 3), (4, 7), (9, 11)], ids=lambda s: "x".join(map(str, s)))
def test_pool9_adjoint_is_the_adjoint(hw, rng):
    """<pool(x), u> == <x, poolT(u)>, exactly the defining property, in float64;
    at sizes 2 and 3 the two folded rows coincide or neighbour each other."""
    x = torch.from_numpy(rng.randn(2, 3, *hw))
    u = torch.from_numpy(rng.randn(2, 3, *hw))
    lhs = (avg_pool_3x3_reflect(x) * u).sum()
    rhs = (x * pool9_adjoint(u)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    assert pool9_adjoint(u[0, 0]).shape == hw  # any leading dims, none included


def test_vjp_ties_follow_the_analytic_rule(rng):
    """``a == b``: SSIM is exactly 1, the clip sits on its lower edge and passes
    nothing (strict range), and sign(0) = 0: both gradients are exactly zero,
    as in the JAX package. Saturated from above: no SSIM gradient either."""
    a = rng.rand(1, 9, 11, 3).astype(np.float32)
    g = rng.randn(1, 9, 11, 1).astype(np.float32)
    ta, tb = photometric_vjp_plain(nchw(a), nchw(a), nchw(g), ALPHA, C1, C2)
    assert torch.count_nonzero(ta) == 0 and torch.count_nonzero(tb) == 0
    ga, gb = jp.photometric_vjp_reference(jnp.asarray(a), jnp.asarray(a), jnp.asarray(g), ALPHA, C1, C2)
    assert not np.asarray(ga).any() and not np.asarray(gb).any()
    # the same through the autograd Function
    leaf = nchw(a).requires_grad_()
    photometric_map(leaf, nchw(a), ALPHA, C1, C2).backward(nchw(g))
    assert torch.count_nonzero(leaf.grad) == 0
    # r >= 1 needs n/d <= -1, which C1, C2 > 0 rule out for real images; force the
    # upper edge with negative constants and see that the SSIM part passes nothing
    b = (1.0 - a).astype(np.float32)
    args = (nchw(a), nchw(b), nchw(g), 1.0, -10.0, 1e-3)
    ref = jp.photometric_vjp_reference(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g), 1.0, -10.0, 1e-3)
    got = photometric_vjp_plain(*args)
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(ref[0]), atol=1e-6)


def test_function_skips_the_gradient_not_asked_for(rng):
    a, b = _pair(rng, (2, 10, 14, 3))
    ta, tb = nchw(a).requires_grad_(), nchw(b)
    out = photometric_map(ta, tb, ALPHA, C1, C2)
    out.mean().backward()  # the mean's backward hands over an expanded cotangent
    assert ta.grad is not None and tb.grad is None
    g = torch.full((2, 1, 10, 14), 1.0 / out.numel())
    want, _ = photometric_vjp_plain(nchw(a), nchw(b), g, ALPHA, C1, C2)
    np.testing.assert_allclose(ta.grad.numpy(), want.numpy(), atol=1e-9, rtol=1e-5)
    only_a = photometric_vjp(nchw(a), nchw(b), g, ALPHA, C1, C2, need_a=True, need_b=False)
    assert only_a[1] is None and torch.equal(only_a[0], want)
    assert photometric_vjp(nchw(a), nchw(b), g, ALPHA, C1, C2, need_a=False, need_b=False) == (None, None)
    # a non-contiguous cotangent
    gt = torch.from_numpy(rng.randn(2, 1, 14, 10).astype(np.float32)).transpose(2, 3)
    tb2 = nchw(b).requires_grad_()
    photometric_map(nchw(a), tb2, ALPHA, C1, C2).backward(gt)
    _, want_b = photometric_vjp_plain(nchw(a), nchw(b), gt.contiguous(), ALPHA, C1, C2)
    np.testing.assert_allclose(tb2.grad.numpy(), want_b.numpy(), atol=1e-7, rtol=1e-5)


def test_bfloat16_inputs_give_bfloat16_gradients(rng):
    a, b = _pair(rng, (1, 8, 12, 3))
    ta, tb = nchw(a).bfloat16().requires_grad_(), nchw(b).bfloat16().requires_grad_()
    g = torch.from_numpy(rng.randn(1, 1, 8, 12).astype(np.float32))
    photometric_map(ta, tb, ALPHA, C1, C2).backward(g)
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16
    wa, wb = photometric_vjp_plain(ta.detach().float(), tb.detach().float(), g, ALPHA, C1, C2)
    # one rounding of the float32 gradient to bfloat16: half an ulp, 2^-9 of the value
    assert ((ta.grad.float() - wa).abs() <= 2.0**-8 * wa.abs() + 1e-12).all()
    assert ((tb.grad.float() - wb).abs() <= 2.0**-8 * wb.abs() + 1e-12).all()
