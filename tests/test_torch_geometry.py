"""The port's geometry/ vs the JAX package on the CPU: same numpy inputs,
float32. Matrices and poses agree to 1e-6; warp coordinates to 1e-4 px (the
projection cancels K against its inverse, so the last bits of the three-term
sums show at the 1e-5 px level)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpledepthestimation_tpu.geometry import camera as jcam
from simpledepthestimation_tpu.geometry import pose as jpose
from simpledepthestimation_tpu_torch.geometry import camera as tcam
from simpledepthestimation_tpu_torch.geometry import pose as tpose

from torch_port_helpers import nchw, nhwc

B, H, W = 2, 24, 40


def _K(rng):
    K = np.tile(np.array([[[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2], [0, 0, 1]]], np.float32), (B, 1, 1))
    K[:, :2] *= (1 + 0.05 * rng.rand(B, 2, 1)).astype(np.float32)
    return K


def test_pose_functions(rng):
    vec = np.concatenate([rng.randn(B, 3), 0.5 * rng.randn(B, 3)], 1).astype(np.float32)
    np.testing.assert_allclose(
        tpose.euler2mat(torch.from_numpy(vec[:, 3:])).numpy(), np.asarray(jpose.euler2mat(jnp.asarray(vec[:, 3:]))), atol=1e-6)
    T_j = np.asarray(jpose.pose_vec2mat(jnp.asarray(vec)))
    T_t = tpose.pose_vec2mat(torch.from_numpy(vec))
    np.testing.assert_allclose(T_t.numpy(), T_j, atol=1e-6)
    np.testing.assert_allclose(
        tpose.invert_pose(T_t).numpy(), np.asarray(jpose.invert_pose(jnp.asarray(T_j))), atol=1e-6)


def test_numpy_pose_helpers(rng):
    for name in ("rotx_np", "roty_np", "rotz_np"):
        np.testing.assert_array_equal(getattr(tpose, name)(0.3), getattr(jpose, name)(0.3))
    packet = list(rng.rand(30))
    R_t, t_t = tpose.pose_from_oxts_packet_np(packet, 0.7)
    R_j, t_j = jpose.pose_from_oxts_packet_np(packet, 0.7)
    np.testing.assert_array_equal(R_t, R_j)
    np.testing.assert_array_equal(t_t, t_j)
    T = tpose.T_from_R_t_np(R_t, t_t)
    np.testing.assert_array_equal(T, jpose.T_from_R_t_np(R_j, t_j))
    np.testing.assert_array_equal(tpose.invert_pose_np(T), jpose.invert_pose_np(T))


def test_intrinsics(rng):
    K = _K(rng)
    np.testing.assert_allclose(
        tcam.scale_intrinsics(torch.from_numpy(K), 0.5, 0.25).numpy(),
        np.asarray(jcam.scale_intrinsics(jnp.asarray(K), 0.5, 0.25)), atol=0, rtol=1e-7)
    np.testing.assert_allclose(
        tcam.inv_intrinsics(torch.from_numpy(K)).numpy(), np.asarray(jcam.inv_intrinsics(jnp.asarray(K))), rtol=1e-6)


@pytest.mark.parametrize("mode,dst", [("bilinear", (12, 20)), ("bilinear", (31, 57)), ("nearest", (12, 20)),
                                      ("nearest", (7, 13)), ("bilinear", (H, W))])
def test_resize_img(mode, dst, rng):
    img = rng.rand(B, H, W, 3).astype(np.float32)
    ref = np.asarray(jcam.resize_img(jnp.asarray(img), dst, mode=mode))
    out = tcam.resize_img(nchw(img), dst, mode=mode)
    # bilinear: the two linspace implementations round some source coordinates
    # one float32 ulp apart (2e-6 at 20-40 px), which shows in the weights
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5 if mode == "bilinear" else 0)


def test_resize_img_avgpool_and_grid(rng):
    img = rng.rand(B, H, W, 3).astype(np.float32)
    ref = np.asarray(jcam.resize_img_avgpool(jnp.asarray(img), (H // 2, W // 4)))
    np.testing.assert_allclose(nhwc(tcam.resize_img_avgpool(nchw(img), (H // 2, W // 4))), ref, atol=1e-6)
    np.testing.assert_array_equal(tcam.image_grid(5, 7).numpy(), np.asarray(jcam.image_grid(5, 7)))


def test_points_round_trip(rng):
    K = _K(rng)
    depth = (1 + 20 * rng.rand(B, H, W, 1)).astype(np.float32)
    vec = np.concatenate([0.2 * rng.randn(B, 3), 0.05 * rng.randn(B, 3)], 1).astype(np.float32)
    T = np.asarray(jpose.pose_vec2mat(jnp.asarray(vec)))
    Kinv = np.asarray(jcam.inv_intrinsics(jnp.asarray(K)))
    pts_j = np.asarray(jcam.img_to_points(jnp.asarray(depth), jnp.asarray(Kinv), jnp.zeros((B, 3, 1))))
    pts_t = tcam.img_to_points(nchw(depth), torch.from_numpy(Kinv.copy()), torch.zeros(B, 3, 1))
    np.testing.assert_allclose(pts_t.numpy(), pts_j, rtol=1e-5, atol=1e-5)

    R = K @ T[:, :3, :3]
    t = K @ T[:, :3, 3:4]
    c_j, z_j, v_j = jcam.points_to_img(jnp.asarray(pts_j), jnp.asarray(R), jnp.asarray(t), H, W)
    c_t, z_t, v_t = tcam.points_to_img(torch.from_numpy(pts_j), torch.from_numpy(R), torch.from_numpy(t), H, W)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)
    np.testing.assert_allclose(nhwc(z_t), np.asarray(z_j), rtol=1e-5)
    # validity may flip only where a coordinate sits within tolerance of a border
    flips = nhwc(v_t) != np.asarray(v_j)
    assert flips.mean() < 1e-3


@pytest.mark.parametrize("dense", [False, True], ids=["rigid", "dense"])
@pytest.mark.parametrize("fn", ["view_synthesis", "view_synthesis_v2"])
def test_view_synthesis(fn, dense, rng):
    K = _K(rng)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    depth = (0.5 + 20 * rng.rand(B, H, W, 1)).astype(np.float32)
    vec = np.concatenate([0.3 * rng.randn(B, 3), 0.03 * rng.randn(B, 3)], 1).astype(np.float32)
    T = np.asarray(jpose.pose_vec2mat(jnp.asarray(vec)))
    R = T[:, :3, :3]
    if dense:
        t = (T[:, :3, 3][:, None, None, :] + 0.05 * rng.randn(B, H, W, 3)).astype(np.float32)
        t_torch = nchw(t)
    else:
        t = T[:, :3, 3:4]
        t_torch = torch.from_numpy(t)
    s_j, d_j, c_j, v_j = getattr(jcam, fn)(
        jnp.asarray(img), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(R), jnp.asarray(t))
    s_t, d_t, c_t, v_t = getattr(tcam, fn)(
        nchw(img), nchw(depth), torch.from_numpy(K), torch.from_numpy(R), t_torch)
    c_j, c_t = np.asarray(c_j), c_t.numpy()
    if fn == "view_synthesis":  # normalized coords → pixels
        scale = np.array([(W - 1) / 2.0, (H - 1) / 2.0], np.float32)
        c_j, c_t = (c_j + 1) * scale, (c_t + 1) * scale
    assert np.abs(c_t - c_j).max() <= 1e-4  # pixels
    np.testing.assert_allclose(nhwc(d_t), np.asarray(d_j), rtol=1e-5)
    assert (nhwc(v_t) != np.asarray(v_j)).mean() < 1e-3
    # sampled values: a 1e-4 px coordinate error times a unit image gradient
    np.testing.assert_allclose(nhwc(s_t), np.asarray(s_j), atol=2e-4)
    # a fraction of the field must really leave the image for the test to bite
    assert 0.02 < 1 - np.asarray(v_j).mean() < 0.9
