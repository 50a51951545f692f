"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; they carry the ``cuda`` marker and
skip where there is no CUDA device (the decision is taken inside a fixture,
at run time). Run them on the GPU machine with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -p no:cacheprovider

float32 tolerance 1e-5: same formula as the plain version, other summation
order. (``python3 chip_smoke.py`` makes the same comparison at the main
path's shapes.)"""

import numpy as np
import pytest
import torch

from simpledepthestimation_tpu_torch.ops.photometric import photometric_map, photometric_map_plain
from simpledepthestimation_tpu_torch.ops.warp import warp_bilinear, warp_bilinear_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, *shape):
    return torch.from_numpy(rng.rand(*shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 3, 37, 83), (1, 1, 8, 8), (3, 5, 64, 640)])
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


def test_cuda_wrappers_raise_instead_of_falling_back(card, rng):
    img = _rand(rng, 1, 3, 8, 8).to(card)
    x, y = _rand(rng, 1, 8, 8).to(card), _rand(rng, 1, 8, 8).to(card)
    with pytest.raises(NotImplementedError, match="training slice"):
        warp_bilinear(img, x.requires_grad_(), y)
    with pytest.raises(NotImplementedError, match="training slice"):
        photometric_map(img.clone().requires_grad_(), img)
    with torch.no_grad():  # no gradient asked for: the kernel runs
        warp_bilinear(img, x, y)
    with pytest.raises(ValueError, match="contiguous"):
        warp_bilinear(img.transpose(2, 3), x.detach(), y)
    with pytest.raises(TypeError):
        warp_bilinear(img.half(), x.detach(), y)
    with pytest.raises(TypeError):
        photometric_map(img, img.bfloat16())
    with pytest.raises(ValueError, match="one device"):
        warp_bilinear(img, x.detach().cpu(), y.cpu())
