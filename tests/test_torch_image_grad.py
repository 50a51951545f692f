"""The warp's image cotangent in the port vs the JAX package on the CPU.

``warp_image_grad_plain`` (the plain version beside the CUDA kernel K5) and the
image gradient of ``resample_bilinear_image_grad`` (the cycle loss's warp)
against ``jax.vjp`` of ``_resample_bilinear_4gather`` w.r.t. the image, in
every coordinate regime of the warp tests, and against the JAX package's
image-cotangent Pallas kernel ``warp_image_cotangent`` in interpret mode with
float32 dots. Same numpy inputs on both sides, float32. Tolerance: the JAX
package's own for this kernel, ``atol 2e-5, rtol 1e-5`` (a pixel that many
output pixels land on sums hundreds of terms in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpledepthestimation_tpu.ops import pallas_warp as pw
from simpledepthestimation_tpu.ops import resample as jres
from simpledepthestimation_tpu_torch.ops import resample as tres
from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear, warp_image_grad, warp_image_grad_plain

from torch_port_helpers import REGIMES, nchw, nhwc

ATOL, RTOL = 2e-5, 1e-5


def _jax_image_vjp(img, x, y, ct):
    _, vjp = jax.vjp(lambda im: jres._resample_bilinear_4gather(im, jnp.asarray(x), jnp.asarray(y)),
                     jnp.asarray(img))
    return np.asarray(vjp(jnp.asarray(ct))[0])


@pytest.mark.parametrize("shape", [(2, 16, 40, 3), (1, 37, 83, 4)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_image_grad_plain_matches_jax_vjp(regime, shape, rng):
    B, H, W, C = shape
    img = rng.rand(B, H, W, C).astype(np.float32)
    x, y = (np.asarray(a, np.float32) for a in REGIMES[regime](rng, B, H, W))
    ct = rng.randn(B, H, W, C).astype(np.float32)
    want = _jax_image_vjp(img, x, y, ct)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = warp_image_grad_plain(tx, ty, nchw(ct), H, W)
    assert got.shape == (B, C, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL, rtol=RTOL)
    # the device-routing wrapper takes the plain version for CPU tensors
    assert torch.equal(warp_image_grad(tx, ty, nchw(ct), H, W), got)
    # and the cycle loss's entry point: gradient into the image only
    image = nchw(img).requires_grad_()
    xg, yg = tx.clone().requires_grad_(), ty.clone().requires_grad_()
    out = tres.resample_bilinear_image_grad(image, xg, yg)
    np.testing.assert_allclose(nhwc(out.detach()), np.asarray(
        jres._resample_bilinear_4gather(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))), atol=1e-6, rtol=0)
    out.backward(nchw(ct))
    assert xg.grad is None and yg.grad is None
    np.testing.assert_allclose(nhwc(image.grad), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("regime", ["coherent", "wild", "bidirectional-large", "oob-borders"])
def test_image_grad_plain_matches_pallas_kernel_interpret(regime, rng):
    """Against ``warp_image_cotangent`` (the TPU kernel's body, interpret mode,
    float32 dots) in the regimes of the JAX package's own kernel test."""
    B, H, W, C = 1, 24, 256, 3
    x, y = (np.asarray(a, np.float32) for a in REGIMES[regime](rng, B, H, W))
    ct = rng.rand(B, H, W, C).astype(np.float32)
    want = np.asarray(pw.warp_image_cotangent(jnp.asarray(ct), jnp.asarray(x), jnp.asarray(y), H,
                                              dot_dtype=jnp.float32, interpret=True))
    got = warp_image_grad_plain(torch.from_numpy(x), torch.from_numpy(y), nchw(ct), H, W)
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL, rtol=RTOL)


def test_image_grad_plain_unaligned_other_image_height(rng):
    """Unaligned Ho, W and Ho != Hin (the JAX package's kernel test case):
    against the Pallas kernel in interpret mode and against ``jax.vjp``."""
    Ho, Hin, Wn, C = 52, 44, 300, 3
    img = rng.rand(2, Hin, Wn, C).astype(np.float32)
    x = (rng.rand(2, Ho, Wn) * (Wn + 6) - 3).astype(np.float32)
    y = (rng.rand(2, Ho, Wn) * (Hin + 6) - 3).astype(np.float32)
    ct = rng.rand(2, Ho, Wn, C).astype(np.float32)
    got = nhwc(warp_image_grad_plain(torch.from_numpy(x), torch.from_numpy(y), nchw(ct), Hin, Wn))
    want = np.asarray(pw.warp_image_cotangent(jnp.asarray(ct), jnp.asarray(x), jnp.asarray(y), Hin,
                                              dot_dtype=jnp.float32, interpret=True))
    assert got.shape == (2, Hin, Wn, C)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _jax_image_vjp(img, x, y, ct), atol=ATOL, rtol=RTOL)


def test_image_grad_other_image_width_and_huge_coords(rng):
    """Wi != Wo (the kernel allows it; the JAX kernel does not) against
    ``jax.vjp``; huge finite coordinates scatter nothing."""
    B, C, Hi, Wi, h, w = 2, 3, 12, 20, 7, 9
    img = rng.rand(B, Hi, Wi, C).astype(np.float32)
    x = (rng.rand(B, h, w) * (Wi + 4) - 2).astype(np.float32)
    y = (rng.rand(B, h, w) * (Hi + 4) - 2).astype(np.float32)
    ct = rng.randn(B, h, w, C).astype(np.float32)
    got = warp_image_grad_plain(torch.from_numpy(x), torch.from_numpy(y), nchw(ct), Hi, Wi)
    np.testing.assert_allclose(nhwc(got), _jax_image_vjp(img, x, y, ct), atol=ATOL, rtol=RTOL)
    big = torch.full((B, h, w), 1e30)
    assert torch.count_nonzero(warp_image_grad_plain(big, -big, nchw(ct), Hi, Wi)) == 0


def test_function_image_gradient_dtype_and_layouts(rng):
    """Through the autograd Function on the CPU: a bfloat16 image gets a
    bfloat16 gradient, the float32 plain result rounded once; strided and
    expanded cotangents give what their contiguous copies give."""
    B, C, H, W = 1, 3, 10, 18
    x = torch.from_numpy((rng.rand(B, H, W) * W).astype(np.float32))
    y = torch.from_numpy((rng.rand(B, H, W) * H).astype(np.float32))
    img = nchw(rng.rand(B, H, W, C).astype(np.float32)).bfloat16().requires_grad_()
    ct = torch.from_numpy(rng.randn(B, C, H, W).astype(np.float32)).bfloat16()
    warp_bilinear(img, x, y).backward(ct)
    assert img.grad.dtype == torch.bfloat16
    assert torch.equal(img.grad, warp_image_grad_plain(x, y, ct.float(), H, W).bfloat16())

    image = nchw(rng.rand(B, H, W, C).astype(np.float32))
    for ct in (torch.from_numpy(rng.randn(B, C, W, H).astype(np.float32)).transpose(2, 3),
               torch.from_numpy(rng.randn(B, C, 1, 1).astype(np.float32)).expand(B, C, H, W)):
        leaf = image.clone().requires_grad_()
        (g,) = torch.autograd.grad(warp_bilinear(leaf, x, y), leaf, ct)
        assert torch.equal(g, warp_image_grad_plain(x, y, ct.contiguous(), H, W))
