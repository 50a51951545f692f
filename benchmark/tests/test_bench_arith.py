"""The FLOP and byte arithmetic, against counts made by hand."""

import pytest


def test_kernel_bounds_by_hand():
    from arith import kernels as K

    # K1 on 1×3×2×2: reads x, y (8 B) and 3 float32 channels, writes 3: 4 px × 32 B
    assert K.warp_fwd(1, 3, 2, 2, 4) == pytest.approx(128 / 3.35e12)
    # K2: 4 px × (2 × 4 × 3 + 4) B = 112 B; 4 × 3 × 100 = 1,200 operations
    assert K.photometric_fwd(1, 3, 2, 2, 4) == pytest.approx(max(112 / 3.35e12, 1200 / 67e12))
    # K3: 4 px × (16 + 24) B; K4 with one gradient: 4 px × (24 + 4 + 12) B, 2,400 operations
    assert K.warp_bwd_coords(1, 3, 2, 2, 4) == pytest.approx(160 / 3.35e12)
    assert K.photometric_bwd(1, 3, 2, 2, 4, 1) == pytest.approx(max(160 / 3.35e12, 2400 / 67e12))


def test_monodepth2_step_by_hand():
    from arith import kernels as K

    # B=1, N=2, 4×8 frames, 2 scales: planes of 32 and 8 pixels, 2 contexts each
    got = K.monodepth2_step(1, 2, 4, 8, scales=2)
    px = 2 * (32 + 8)
    assert got["warp_bilinear_fwd"] == pytest.approx(px * 32 / 3.35e12)
    assert got["photometric_map_fwd"] == pytest.approx(2 * px * 28 / 3.35e12)
    assert got["warp_bilinear_bwd_coords"] == pytest.approx(px * 40 / 3.35e12)
    assert got["photometric_map_bwd"] == pytest.approx(px * 40 / 3.35e12)


def test_model_flops_scale_with_the_batch(bench):
    import json
    import os

    from arith.flops import train_step_flops
    from conftest import ROOT

    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", "md2_r18.json")))["cfg"]
    one = train_step_flops(cfg, 1, 2, 64, 128)
    assert train_step_flops(cfg, 3, 2, 64, 128) == 3 * one
    # the first convolution, 3 → 64 channels 7×7 stride 2: 2·64·3·49 per output pixel forward, and
    # its weight gradient as much again (its input needs no gradient)
    stem = 2 * 64 * 3 * 49 * 32 * 64
    assert one > 2 * stem


@pytest.mark.parametrize("config, per_image", [("md2_r18", 49_767_944_328), ("packnet_1a", 1_232_034_762_888)])
def test_model_flops_at_the_cells_frames(config, per_image):
    import json
    import os

    from arith.flops import train_step_flops
    from conftest import ROOT

    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")))["cfg"]
    assert train_step_flops(cfg, 1, 2, 192, 640) == per_image
