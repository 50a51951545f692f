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


# the forward's tiles are 64 columns by 32 rows (16 rows where the grid of 32-row tiles
# would not fill the card once: (64, 3, 70, 150) takes 32-row tiles, the rest 16-row ones),
# each staged with a reflected one-pixel halo: planes that are not a multiple of either, and
# H or W of 2 and 3, where the reflection folds the halo onto the plane's other side
@pytest.mark.parametrize("shape", [(2, 3, 2, 70), (1, 3, 3, 65), (2, 3, 33, 2), (2, 3, 35, 3), (1, 3, 45, 130),
                                   (3, 2, 31, 127), (64, 3, 70, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_photometric_kernel_ragged_tiles(shape, dtype, card, rng):
    a = _rand(rng, *shape).to(card).to(dtype)
    b = (0.8 * a.float() + 0.2 * _rand(rng, *shape).to(card)).to(dtype)
    before = photometric_map.launches
    out = photometric_map(a, b, 0.85, 1e-4, 9e-4)
    torch.cuda.synchronize()
    assert photometric_map.launches == before + 1
    assert out.shape == (shape[0], 1, *shape[2:]) and out.dtype == torch.float32
    # bfloat16 inputs convert to float32 exactly on both sides: the float32 limit holds
    assert (out - photometric_map_plain(a, b, 0.85, 1e-4, 9e-4)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(2, 3, 37, 83), (1, 3, 2, 3), (64, 3, 70, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_photometric_kernel_tie_gives_zero(shape, dtype, card, rng):
    """a == b: every window's numerator equals its denominator and |a - b| = 0,
    so the map is exactly 0, as the plain version's."""
    a = _rand(rng, *shape).to(card).to(dtype)
    assert torch.count_nonzero(photometric_map(a, a.clone(), 0.85, 1e-4, 9e-4)) == 0
    assert torch.count_nonzero(photometric_map_plain(a, a.clone(), 0.85, 1e-4, 9e-4)) == 0


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


# K3 on its 8x32 output tiles: planes whose height is not a multiple of 8 and width not
# one of 32 (ragged tiles), output planes of another size than the image, every channel
# count from 1 to 5 (3 and 4 have loops of their own, the others the generic one), corners
# on the exact edges, float32 and bfloat16; an expanded (stride-0) cotangent; two launches
# bit-equal (one writer per output, no atomics)
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("in_hw,out_hw", [((37, 83), (37, 83)), ((37, 83), (21, 45)), ((44, 300), (52, 300)),
                                          ((16, 64), (9, 33))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_backward_kernel_tiles(C, in_hw, out_hw, dtype, card, rng):
    (H, W), (h, w) = in_hw, out_hw
    B = 3
    img = _rand(rng, B, C, H, W).to(card).to(dtype)
    x = (_rand(rng, B, h, w) * (W * 1.5) - W * 0.25).to(card)
    y = (_rand(rng, B, h, w) * (H * 1.5) - H * 0.25).to(card)
    x[0, :3], y[1, :, :3] = W - 1.0, H - 1.0
    for ct in ((_rand(rng, B, C, h, w) - 0.5).to(card).to(dtype),
               (_rand(rng, B, C, 1, 1) - 0.5).to(card).to(dtype).expand(B, C, h, w)):
        before = warp_bilinear.bwd_launches
        dx, dy = warp_coord_grad(img, x, y, ct)
        again = warp_coord_grad(img, x, y, ct)
        torch.cuda.synchronize()
        assert warp_bilinear.bwd_launches == before + 2
        assert torch.equal(dx, again[0]) and torch.equal(dy, again[1])
        assert dx.shape == (B, h, w) and dx.dtype == torch.float32
        rx, ry = warp_coord_grad_plain(img, x, y, ct)
        scale = max(rx.abs().max().item(), ry.abs().max().item())
        assert scale > 0
        assert (dx - rx).abs().max().item() <= 1e-5 * scale and (dy - ry).abs().max().item() <= 1e-5 * scale


def test_warp_backward_kernel_non_finite_and_outside_coordinates(card, rng):
    """K3 at NaN and infinite coordinates and at pixels whose four corners all
    lie outside the image, with finite and non-finite cotangents there: NaN
    where the plain version gives NaN, its values elsewhere (0 outside)."""
    B, C, H, W = 2, 3, 21, 46
    img = _rand(rng, B, C, H, W).to(card)
    ct = (_rand(rng, B, C, H, W) - 0.5).to(card)
    x, y = (_rand(rng, B, H, W) * W).to(card), (_rand(rng, B, H, W) * H).to(card)
    x[0, 0, :5], y[0, 1, :5], x[1, 2, :5] = float("nan"), float("inf"), float("-inf")
    x[1, 3, :10], y[1, 4, :10] = 1e30, -3.5  # finite and wholly outside
    ct[1, 0, 3, 5:10], ct[1, 2, 4, 5:10] = float("inf"), float("nan")  # non-finite there
    dx, dy = warp_coord_grad(img, x, y, ct)
    torch.cuda.synchronize()
    rx, ry = warp_coord_grad_plain(img, x, y, ct)
    for got, want in ((dx, rx), (dy, ry)):
        assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(want[1, 3:5, 5:10]).all()
        ok = ~torch.isnan(want)
        assert (got[ok] - want[ok]).abs().max().item() <= 1e-5 * want[ok].abs().max().item()
        assert (got[1, 3, :5] == 0).all() and (got[1, 4, :5] == 0).all()


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


def _shared_corner_coords(case, rng, B, h, w, H, W):
    """Coordinates whose corners many lanes of a warp (32 consecutive pixels of a row) share."""
    cols = torch.arange(w, dtype=torch.float32).expand(B, h, w)
    rows = torch.arange(h, dtype=torch.float32)[:, None].expand(B, h, w)
    if case == "one_address":  # every pixel of a plane at one point
        return torch.full((B, h, w), W * 0.37 + 0.25), torch.full((B, h, w), H * 0.61 + 0.5)
    if case == "one_address_per_warp":  # each warp's 32 pixels at one point of their own
        return (cols // 32) * 2.5 + 1.25, rows * 0.75 + 0.5
    if case == "adjacent_lanes":  # a shift: lane j's right corners are lane j+1's left ones
        return cols * (W - 2.0) / w + 0.3, rows * (H - 2.0) / h + 0.6
    # neighbours on one corner but not all: a slow, noisy drift, some pixels clamped to the border
    x = cols * 0.4 + 3.0 + _rand(rng, B, h, w) * 2.0 - 1.0
    y = rows * 0.4 - 2.0 + _rand(rng, B, h, w) * 2.0
    return x.clamp(0, W - 1.0), y.clamp(0, H - 1.0)


@pytest.mark.parametrize("case", ["one_address", "one_address_per_warp", "adjacent_lanes", "drift_clamped"])
@pytest.mark.parametrize("shape,out_hw", [((2, 3, 37, 83), (37, 83)), ((2, 3, 128, 416), (128, 416)),
                                          ((1, 5, 44, 300), (52, 300))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_image_grad_kernel_shared_corners(case, shape, out_hw, dtype, card, rng):
    """The image cotangent where lanes share addresses (the sums of a warp's groups
    and of the block's window) against the plain version, to 2e-5 plus 1e-5 of the
    sum of the terms' sizes."""
    B, C, H, W = shape
    h, w = out_hw
    x, y = _shared_corner_coords(case, rng, B, h, w, H, W)
    x, y = x.contiguous().to(card), y.contiguous().to(card)
    ct = (_rand(rng, B, C, h, w) - 0.5).to(card).to(dtype)
    before = warp_bilinear.bwd_image_launches
    got = warp_image_grad(x, y, ct, H, W)
    torch.cuda.synchronize()
    assert warp_bilinear.bwd_image_launches == before + 1
    want = warp_image_grad_plain(x, y, ct.float(), H, W)
    scale = warp_image_grad_plain(x, y, ct.float().abs(), H, W)
    assert want.abs().max().item() > 0
    assert ((got - want).abs() <= 2e-5 + 1e-5 * scale).all()


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
