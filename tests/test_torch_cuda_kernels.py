"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; they carry the ``cuda`` marker and
skip where there is no CUDA device (the decision is taken inside a fixture,
at run time). Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -p no:cacheprovider

float32 tolerance 1e-5: same formula as the plain version, other summation
order. The backward kernels are held relative to the largest value of the
plain version's result: 1e-5 for the warp's coordinate cotangents, 1e-4 for the
photometric VJP (its variance terms cancel before they are divided by
denominators down to C2). The warp's image cotangent adds with atomics in no
fixed order: ``atol 2e-5, rtol 1e-5`` as the JAX package's test of its kernel. (``python3 chip_smoke.py`` makes the same comparisons
at the main path's shapes.)"""

import numpy as np
import pytest
import torch

from simpledepthestimation_tpu_torch.ops.photometric import (
    photometric_map, photometric_map_plain, photometric_vjp, photometric_vjp_plain,
)
from simpledepthestimation_tpu_torch.ops.warp import (
    warp_bilinear, warp_bilinear_plain, warp_coord_grad, warp_coord_grad_plain, warp_image_grad,
    warp_image_grad_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, *shape):
    return torch.from_numpy(rng.rand(*shape).astype(np.float32))


# the forward takes 4 pixels a thread with 16-byte accesses where the plane's size is a
# multiple of 4, one by one otherwise: odd planes (37x83), rows not a multiple of 4 (21x46),
# aligned planes (16x64, 64x640), and every channel count from 1 to 5
@pytest.mark.parametrize("shape", [(2, 3, 37, 83), (1, 1, 8, 8), (3, 5, 64, 640), (3, 1, 37, 83), (3, 2, 21, 46),
                                   (2, 4, 16, 64), (3, 5, 21, 46), (2, 4, 37, 83)])
@pytest.mark.parametrize("spread", [1.0, 3.0], ids=["inside", "one-plane-outside"])
def test_warp_kernel_matches_plain(shape, spread, card, rng):
    B, C, H, W = shape
    img = _rand(rng, *shape).to(card)
    x = ((_rand(rng, B, H, W) * spread - (spread - 1) / 2) * W).to(card)
    y = ((_rand(rng, B, H, W) * spread - (spread - 1) / 2) * H).to(card)
    before = warp_bilinear.launches
    out = warp_bilinear(img, x, y)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before + 1
    assert (out - warp_bilinear_plain(img, x, y)).abs().max().item() <= 1e-5
    # the CPU path is the same function
    assert (out.cpu() - warp_bilinear(img.cpu(), x.cpu(), y.cpu())).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(2, 3, 37, 83), (1, 2, 2, 2), (2, 3, 192, 640)])
def test_photometric_kernel_matches_plain(shape, card, rng):
    a, b = _rand(rng, *shape).to(card), _rand(rng, *shape).to(card)
    before = photometric_map.launches
    out = photometric_map(a, b, 0.85, 1e-4, 9e-4)
    torch.cuda.synchronize()
    assert photometric_map.launches == before + 1
    assert (out - photometric_map_plain(a, b, 0.85, 1e-4, 9e-4)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape,out_hw", [((2, 3, 37, 83), (37, 83)), ((1, 1, 8, 8), (8, 8)),
                                          ((2, 5, 37, 83), (21, 45)), ((3, 3, 64, 640), (64, 640))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_backward_kernel_matches_plain(shape, out_hw, dtype, card, rng):
    B, C, H, W = shape
    h, w = out_hw
    img = _rand(rng, *shape).to(card).to(dtype)
    x = ((_rand(rng, B, h, w) * 3 - 1) * W).to(card)
    y = ((_rand(rng, B, h, w) * 3 - 1) * H).to(card)
    ct = (_rand(rng, B, C, h, w) - 0.5).to(card).to(dtype)
    before = warp_bilinear.bwd_launches
    dx, dy = warp_coord_grad(img, x, y, ct)
    torch.cuda.synchronize()
    assert warp_bilinear.bwd_launches == before + 1
    rx, ry = warp_coord_grad_plain(img, x, y, ct)
    scale = max(rx.abs().max().item(), ry.abs().max().item())
    assert (dx - rx).abs().max().item() <= 1e-5 * scale and (dy - ry).abs().max().item() <= 1e-5 * scale
    # through the autograd Function, with an expanded cotangent; deterministic
    xg = x.clone().requires_grad_()
    warp_bilinear(img, xg, y).sum().backward()
    again = xg.grad.clone()
    xg.grad = None
    warp_bilinear(img, xg, y).sum().backward()
    assert torch.equal(xg.grad, again)
    want, _ = warp_coord_grad_plain(img, x, y, torch.ones(B, C, h, w, device=card, dtype=dtype))
    assert (xg.grad - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1e-30)


@pytest.mark.parametrize("shape", [(2, 3, 37, 83), (1, 2, 2, 2), (1, 1, 2, 5), (2, 3, 3, 3), (2, 3, 192, 640),
                                   (1, 3, 3, 2), (1, 1, 2, 3), (2, 3, 33, 63)])
@pytest.mark.parametrize("both", [(True, False), (True, True), (False, True)], ids=["g_a", "g_a-g_b", "g_b"])
def test_photometric_backward_kernel_matches_plain(shape, both, card, rng):
    need_a, need_b = both
    a = _rand(rng, *shape).to(card)
    b = (0.8 * a + 0.2 * _rand(rng, *shape).to(card))
    g = _rand(rng, shape[0], 1, *shape[2:]).to(card)
    before = photometric_map.bwd_launches
    got = photometric_vjp(a, b, g, 0.85, 1e-4, 9e-4, need_a=need_a, need_b=need_b)
    torch.cuda.synchronize()
    assert photometric_map.bwd_launches == before + 1
    assert (got[0] is not None) == need_a and (got[1] is not None) == need_b
    want = photometric_vjp_plain(a, b, g, 0.85, 1e-4, 9e-4)
    for k, r in zip(got, want):
        if k is not None:
            assert (k - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    # through the autograd Function: an input that needs no gradient gets none
    ag, bg = a.clone().requires_grad_(need_a), b.clone().requires_grad_(need_b)
    photometric_map(ag, bg, 0.85, 1e-4, 9e-4).backward(g)
    for leaf, k in ((ag, got[0]), (bg, got[1])):
        assert torch.equal(leaf.grad, k) if k is not None else leaf.grad is None
    # ties: a == b gives exactly zero
    ties = photometric_vjp(a, a.clone(), g, 0.85, 1e-4, 9e-4, need_a=need_a, need_b=need_b)
    assert all(torch.count_nonzero(t) == 0 for t in ties if t is not None)


@pytest.mark.parametrize("shape,out_hw", [((2, 3, 37, 83), (37, 83)), ((2, 3, 44, 300), (52, 300)),
                                          ((2, 5, 37, 83), (21, 45)), ((3, 3, 64, 640), (64, 640))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_image_grad_kernel_matches_plain(shape, out_hw, dtype, card, rng):
    B, C, H, W = shape
    h, w = out_hw
    x = ((_rand(rng, B, h, w) * 3 - 1) * W).to(card)
    y = ((_rand(rng, B, h, w) * 3 - 1) * H).to(card)
    x[0, :4] = W - 1.0  # exact edges: the right corner is masked
    y[-1, :, :4] = 0.0
    ct = (_rand(rng, B, C, h, w) - 0.5).to(card).to(dtype)
    before = warp_bilinear.bwd_image_launches
    got = warp_image_grad(x, y, ct, H, W)
    torch.cuda.synchronize()
    assert warp_bilinear.bwd_image_launches == before + 1
    assert got.shape == (B, C, H, W) and got.dtype == torch.float32
    want = warp_image_grad_plain(x, y, ct.float(), H, W)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    # border-clamped coordinates (what view synthesis makes): many pixels on one address, and
    # the signed terms cancel, so the relative part is taken of the sum of their sizes
    xc, yc = x.clamp(0, W - 1), y.clamp(0, H - 1)
    err = (warp_image_grad(xc, yc, ct, H, W) - warp_image_grad_plain(xc, yc, ct.float(), H, W)).abs()
    assert (err <= 2e-5 + 1e-5 * warp_image_grad_plain(xc, yc, ct.float().abs(), H, W)).all()
    # through the autograd Function: the image gradient in the image's dtype
    img = _rand(rng, B, C, H, W).to(card).to(dtype).requires_grad_()
    warp_bilinear(img, x, y).backward(ct)
    assert img.grad.dtype == dtype
    torch.testing.assert_close(img.grad.float(), want.to(dtype).float(), atol=2e-5 if dtype == torch.float32 else 1e-2,
                               rtol=1e-5 if dtype == torch.float32 else 2.0**-7)


def test_warp_forward_then_image_gradient_chain(card, rng):
    """K1 then K5: the gradient of a weighted sum of the warp of a field in
    that field, at detached coordinates, against autograd of the plain
    version (its scatter)."""
    B, C, H, W = 4, 3, 48, 160
    t = _rand(rng, B, C, H, W).to(card) - 0.5
    x = (_rand(rng, B, H, W) * (W + 8) - 4).clamp(0, W - 1).to(card)
    y = (_rand(rng, B, H, W) * (H + 8) - 4).clamp(0, H - 1).to(card)
    weight = _rand(rng, B, C, H, W).to(card)

    def grad(warp):
        leaf = t.clone().requires_grad_()
        (g,) = torch.autograd.grad((warp(leaf, x, y) ** 2 * weight).sum(), leaf)
        return g

    counts = (warp_bilinear.launches, warp_bilinear.bwd_launches, warp_bilinear.bwd_image_launches)
    got = grad(warp_bilinear)
    torch.cuda.synchronize()
    assert (warp_bilinear.launches, warp_bilinear.bwd_launches, warp_bilinear.bwd_image_launches) == (
        counts[0] + 1, counts[1], counts[2] + 1)
    torch.testing.assert_close(got, grad(warp_bilinear_plain), atol=2e-5, rtol=1e-5)


def test_cuda_wrappers_raise_instead_of_falling_back(card, rng):
    img = _rand(rng, 1, 3, 8, 8).to(card)
    x, y = _rand(rng, 1, 8, 8).to(card), _rand(rng, 1, 8, 8).to(card)
    # the image, the coordinates and both photometric inputs are differentiable on the card
    counts = (warp_bilinear.bwd_launches, warp_bilinear.bwd_image_launches, photometric_map.bwd_launches)
    xg = x.clone().requires_grad_()
    ag = img.clone().requires_grad_()
    ig = img.clone().requires_grad_()
    (photometric_map(warp_bilinear(ig, xg, y), ag).sum()).backward()
    assert xg.grad is not None and ag.grad is not None and ig.grad is not None
    assert (warp_bilinear.bwd_launches, warp_bilinear.bwd_image_launches, photometric_map.bwd_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    with pytest.raises(ValueError, match="contiguous"):
        warp_bilinear(img.transpose(2, 3), x, y)
    with pytest.raises(TypeError):
        warp_bilinear(img.half(), x, y)
    with pytest.raises(TypeError):
        photometric_map(img, img.bfloat16())
    with pytest.raises(TypeError, match="dtype"):
        warp_coord_grad(img, x, y, torch.zeros(1, 3, 8, 8, device=card, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="one device"):
        warp_bilinear(img, x.cpu(), y.cpu())
    with pytest.raises(TypeError):
        warp_image_grad(x, y, img.half(), 8, 8)
