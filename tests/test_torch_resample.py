"""The port's plain bilinear warp vs the JAX package on the CPU.

Same numpy inputs on both sides, float32. Tolerance 1e-6 absolute on images in
[0,1): both sides evaluate the same four-corner formula in float32 and differ
only in the last bits. Against the Pallas kernels in interpret mode (float32
dots) the JAX package's own tests allow 3e-6, used here too. Gradients: 1e-5,
sums of many float32 terms in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.ops import pallas_warp as pw
from simpledepthestimation_tpu.ops import resample as jres
from simpledepthestimation_tpu_torch.ops import resample as tres
from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_plain

from torch_port_helpers import nchw, nhwc


def _grid(B, H, W):
    xs = np.tile(np.arange(W, dtype=np.float32), (B, H, 1))
    ys = np.tile(np.arange(H, dtype=np.float32)[:, None], (B, 1, W))
    return xs, ys


def _coherent(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return xs - 5.0 * rng.rand(B, H, W) + 2.0 * (rng.rand(B, H, W) - 0.5), ys + 3.0 * (rng.rand(B, H, W) - 0.5)


def _wild(rng, B, H, W):
    return rng.rand(B, H, W) * (W - 1), rng.rand(B, H, W) * (H - 1)


def _bidirectional(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return (np.clip(xs + 170 * (rng.rand(B, H, W) - 0.5), 0, W - 1),
            np.clip(ys + 150 * (rng.rand(B, H, W) - 0.5), 0, H - 1))


def _oob_borders(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return xs - 20 * rng.rand(B, H, W) + 10, ys + 10 * (rng.rand(B, H, W) - 0.7)


def _fully_outside(rng, B, H, W):
    return (rng.rand(B, H, W) * 3 - 1) * W, (rng.rand(B, H, W) * 3 - 1) * H


def _minus_one_to_zero(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return -rng.rand(B, H, W), ys - rng.rand(B, H, W)


def _exact_edges(rng, B, H, W):
    """Integer coordinates incl. x == W-1 and y == H-1 (corner at W / H is masked)."""
    xs, ys = _grid(B, H, W)
    x = np.where(rng.rand(B, H, W) < 0.5, W - 1.0, xs)
    y = np.where(rng.rand(B, H, W) < 0.5, H - 1.0, ys)
    return x, y


def _bimodal_border_clip(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    y = np.where(rng.rand(B, H, W) < 0.5, 0.0, H - 1.0)
    return xs + rng.rand(B, H, W), y


def _large_uniform_shift(rng, B, H, W):
    xs, ys = _grid(B, H, W)
    return xs + 0.4 * W + rng.rand(B, H, W), ys - 0.3 * H + rng.rand(B, H, W)


REGIMES = {
    "coherent": _coherent,
    "wild": _wild,
    "bidirectional-large": _bidirectional,
    "oob-borders": _oob_borders,
    "fully-outside": _fully_outside,
    "x-in-minus1-0": _minus_one_to_zero,
    "exact-edges": _exact_edges,
    "bimodal-border-clip": _bimodal_border_clip,
    "large-uniform-shift": _large_uniform_shift,
}
SHAPES = [(2, 16, 40, 3), (1, 37, 83, 3), (2, 24, 80, 5)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_plain_warp_matches_jax_oracle(regime, shape, rng):
    B, H, W, C = shape
    img = rng.rand(B, H, W, C).astype(np.float32)
    x, y = (np.asarray(a, np.float32) for a in REGIMES[regime](rng, B, H, W))
    ref = np.asarray(jres._resample_bilinear_4gather(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    out = warp_bilinear_plain(nchw(img), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    out_w = tres.resample_bilinear(nchw(img), torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(out, out_w)


def test_other_output_size_and_huge_coords(rng):
    B, H, W, C = 2, 12, 20, 3
    img = rng.rand(B, H, W, C).astype(np.float32)
    x = (rng.rand(B, 7, 9) * (W + 4) - 2).astype(np.float32)
    y = (rng.rand(B, 7, 9) * (H + 4) - 2).astype(np.float32)
    ref = np.asarray(jres._resample_bilinear_4gather(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    out = warp_bilinear(nchw(img), torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == (B, C, 7, 9)
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)
    # huge finite coordinates stay outside: exact zeros, no integer overflow
    big = torch.full((B, 7, 9), 1e30)
    assert torch.count_nonzero(warp_bilinear(nchw(img), big, -big)) == 0
    assert torch.count_nonzero(warp_bilinear(nchw(img), -big, big)) == 0


def test_plain_warp_matches_tiled_pallas_kernel_interpret(rng):
    """W >= 512 takes the JAX package's production (tiled) route."""
    B, H, W, C = 1, 16, 640, 3
    img = rng.rand(B, H, W, C).astype(np.float32)
    x, y = (np.asarray(a, np.float32) for a in _coherent(rng, B, H, W))
    ref = pw.warp_banded(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                         dot_dtype=jnp.float32, interpret=True, xwin=512, ywin=96)
    out = warp_bilinear_plain(nchw(img), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=3e-6, rtol=0)


def test_plain_warp_matches_v1_pallas_kernel_interpret(rng):
    """W < 512 takes the row-banded (v1) route."""
    B, H, W, C = 1, 24, 128, 3
    img = rng.rand(B, H, W, C).astype(np.float32)
    x, y = (np.asarray(a, np.float32) for a in _oob_borders(rng, B, H, W))
    ref = pw.warp_banded(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                         dot_dtype=jnp.float32, interpret=True)
    out = warp_bilinear_plain(nchw(img), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=3e-6, rtol=0)


def test_grid_sample_and_unstacked_resampler(rng):
    B, H, W, C = 2, 14, 22, 3
    img = rng.rand(B, H, W, C).astype(np.float32)
    grid = (rng.rand(B, H, W, 2) * 2.4 - 1.2).astype(np.float32)
    ref = np.asarray(jres.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid)))
    out = tres.grid_sample_bilinear(nchw(img), torch.from_numpy(grid))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)
    # and against the library definition the semantics come from
    lib = torch.nn.functional.grid_sample(nchw(img), torch.from_numpy(grid), mode="bilinear",
                                          padding_mode="zeros", align_corners=True)
    np.testing.assert_allclose(out.numpy(), lib.numpy(), atol=1e-5, rtol=0)

    x = (rng.rand(B, H, W) * (W + 2) - 1).astype(np.float32)
    y = (rng.rand(B, H, W) * (H + 2) - 1).astype(np.float32)
    ref = np.asarray(jres.resampler_with_unstacked_warp(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    out = tres.resampler_with_unstacked_warp(nchw(img), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("regime", ["coherent", "oob-borders"])
def test_plain_warp_autograd_matches_jax_vjp(regime, rng):
    """d/dx, d/dy and d/d image of the plain version: what the backward
    kernels of the training slice will be held against."""
    B, H, W, C = 2, 12, 24, 3
    img = rng.rand(B, H, W, C).astype(np.float32)
    x, y = (np.asarray(a, np.float32) for a in REGIMES[regime](rng, B, H, W))
    ct = rng.randn(B, H, W, C).astype(np.float32)

    _, vjp = jax.vjp(jres._resample_bilinear_4gather, jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    g_img, g_x, g_y = (np.asarray(g) for g in vjp(jnp.asarray(ct)))

    t_img = nchw(img).requires_grad_()
    t_x = torch.from_numpy(x).requires_grad_()
    t_y = torch.from_numpy(y).requires_grad_()
    warp_bilinear(t_img, t_x, t_y).backward(nchw(ct))
    np.testing.assert_allclose(nhwc(t_img.grad), g_img, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_x.grad.numpy(), g_x, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_y.grad.numpy(), g_y, atol=1e-5, rtol=0)


def test_bfloat16_image_computes_in_float32(rng):
    B, H, W, C = 1, 10, 18, 3
    img = nchw(rng.rand(B, H, W, C).astype(np.float32)).bfloat16()
    x = torch.from_numpy((rng.rand(B, H, W) * W).astype(np.float32))
    y = torch.from_numpy((rng.rand(B, H, W) * H).astype(np.float32))
    out = warp_bilinear(img, x, y)
    assert out.dtype == torch.bfloat16
    ref = warp_bilinear_plain(img.float(), x, y)
    # one rounding of a float32 result in [0,1) to bfloat16: half an ulp = 2^-9
    assert (out.float() - ref).abs().max() <= 2.0**-9


# --- the coordinate cotangents (what the backward kernel computes) -----------

from simpledepthestimation_tpu_torch.ops.warp import warp_coord_grad, warp_coord_grad_plain  # noqa: E402


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_coord_grad_plain_matches_jax_vjp(regime, rng):
    """``warp_coord_grad_plain`` vs ``jax.vjp`` of the 4-gather oracle w.r.t. x
    and y, in every coordinate regime (exact edges and fully outside included):
    1e-5, a sum over the channels in another order."""
    B, H, W, C = 2, 16, 40, 3
    img = rng.rand(B, H, W, C).astype(np.float32)
    x, y = (np.asarray(a, np.float32) for a in REGIMES[regime](rng, B, H, W))
    ct = rng.randn(B, H, W, C).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, yy: jres._resample_bilinear_4gather(jnp.asarray(img), xx, yy),
                     jnp.asarray(x), jnp.asarray(y))
    g_x, g_y = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    dx, dy = warp_coord_grad_plain(nchw(img), torch.from_numpy(x), torch.from_numpy(y), nchw(ct))
    assert dx.shape == dy.shape == (B, H, W) and dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), g_x, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dy.numpy(), g_y, atol=1e-5, rtol=0)
    # the device-routing wrapper takes the plain version for CPU tensors
    wx, wy = warp_coord_grad(nchw(img), torch.from_numpy(x), torch.from_numpy(y), nchw(ct))
    assert torch.equal(wx, dx) and torch.equal(wy, dy)


@pytest.mark.parametrize("route", ["tiled", "v1"])
def test_coord_grad_plain_matches_pallas_backward_kernels_interpret(route, rng):
    """Against the JAX package's coordinate-backward Pallas kernels in interpret
    mode with float32 dots: ``_call_tiled_bwd`` (W >= 512) and
    ``_call_bwd_coords`` (W < 512), reached through ``warp_banded``'s VJP as the
    package's own tests reach them."""
    if route == "tiled":
        (B, H, W, C), kw, regime = (1, 16, 640, 3), dict(xwin=512, ywin=96), _coherent
    else:
        (B, H, W, C), kw, regime = (1, 24, 128, 3), {}, _oob_borders
    img = rng.rand(B, H, W, C).astype(np.float32)
    x, y = (np.asarray(a, np.float32) for a in regime(rng, B, H, W))
    ct = rng.randn(B, H, W, C).astype(np.float32)
    _, vjp = jax.vjp(
        lambda xx, yy: pw.warp_banded(jnp.asarray(img), xx, yy, dot_dtype=jnp.float32, interpret=True,
                                      image_grad=False, **kw),
        jnp.asarray(x), jnp.asarray(y))
    g_x, g_y = (np.asarray(g) for g in vjp(jnp.asarray(ct)))
    dx, dy = warp_coord_grad_plain(nchw(img), torch.from_numpy(x), torch.from_numpy(y), nchw(ct))
    np.testing.assert_allclose(dx.numpy(), g_x, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dy.numpy(), g_y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ct_kind", ["contiguous", "non-contiguous", "expanded"])
def test_function_gradient_equals_autograd_of_plain(ct_kind, rng):
    """The autograd Function on the CPU (explicit coordinate formula, image
    gradient by autograd of the plain version) vs autograd of
    ``warp_bilinear_plain``, at another output size, for the cotangent layouts
    autograd hands over."""
    B, C, H, W, h, w = 2, 3, 12, 20, 7, 9
    img = nchw(rng.rand(B, H, W, C).astype(np.float32))
    x = torch.from_numpy((rng.rand(B, h, w) * (W + 4) - 2).astype(np.float32))
    y = torch.from_numpy((rng.rand(B, h, w) * (H + 4) - 2).astype(np.float32))
    if ct_kind == "contiguous":
        ct = torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32))
    elif ct_kind == "non-contiguous":
        ct = torch.from_numpy(rng.randn(B, C, w, h).astype(np.float32)).transpose(2, 3)
    else:
        ct = torch.from_numpy(rng.randn(B, C, 1, 1).astype(np.float32)).expand(B, C, h, w)
    assert ct.is_contiguous() == (ct_kind == "contiguous")

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (img, x, y)]
        return torch.autograd.grad(fn(*leaves), leaves, ct)

    for got, want in zip(grads(warp_bilinear), grads(warp_bilinear_plain)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_function_computes_only_the_gradients_asked_for(rng):
    B, C, H, W = 1, 3, 8, 10
    img = nchw(rng.rand(B, H, W, C).astype(np.float32))
    x = torch.from_numpy((rng.rand(B, H, W) * W).astype(np.float32)).requires_grad_()
    y = torch.from_numpy((rng.rand(B, H, W) * H).astype(np.float32))
    out = warp_bilinear(img, x, y)
    out.sum().backward()  # the sum's backward hands over an expanded cotangent
    assert x.grad is not None and y.grad is None and img.grad is None
    want, _ = warp_coord_grad_plain(img, x.detach(), y, torch.ones_like(out))
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # no gradient asked for: no graph
    assert not warp_bilinear(img, x.detach(), y).requires_grad


def test_bfloat16_image_coordinate_gradient(rng):
    """A bfloat16 image gives a bfloat16 output and cotangent; the coordinate
    gradient is float32, computed in float32 from the exactly converted values."""
    B, C, H, W = 1, 3, 10, 18
    img = nchw(rng.rand(B, H, W, C).astype(np.float32)).bfloat16()
    x = torch.from_numpy((rng.rand(B, H, W) * W).astype(np.float32)).requires_grad_()
    y = torch.from_numpy((rng.rand(B, H, W) * H).astype(np.float32)).requires_grad_()
    ct = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)).bfloat16()
    out = warp_bilinear(img, x, y)
    assert out.dtype == torch.bfloat16
    out.backward(ct)
    assert x.grad.dtype == y.grad.dtype == torch.float32
    dx, dy = warp_coord_grad_plain(img.float(), x.detach(), y.detach(), ct.float())
    np.testing.assert_allclose(x.grad.numpy(), dx.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(y.grad.numpy(), dy.numpy(), atol=1e-6, rtol=0)
