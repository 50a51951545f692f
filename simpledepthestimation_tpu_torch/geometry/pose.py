"""SE(3) pose utilities: numpy (dataset-side) + torch (model-side).

Counterpart of ``simpledepthestimation_tpu/geometry/pose.py``. The torch
variants are functional, batch-first and float32; the 3×3 products are written
out as broadcast multiply-adds (see geometry/camera.py on why no matmul).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# numpy side (used by dataset indexing: OXTS GPS → SE(3))
# ---------------------------------------------------------------------------


def rotx_np(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty_np(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz_np(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


OxtsPacket = namedtuple(
    "OxtsPacket",
    "lat, lon, alt, "
    "roll, pitch, yaw, "
    "vn, ve, vf, vl, vu, "
    "ax, ay, az, af, al, au, "
    "wx, wy, wz, wf, wl, wu, "
    "pos_accuracy, vel_accuracy, "
    "navstat, numsats, "
    "posmode, velmode, orimode",
)


def pose_from_oxts_packet_np(raw_data, scale: float):
    """Mercator-projected SE(3) pose from a KITTI OXTS packet."""
    packet = OxtsPacket(*raw_data)
    er = 6378137.0  # earth radius (approx.) in meters

    tx = scale * packet.lon * np.pi * er / 180.0
    ty = scale * er * np.log(np.tan((90.0 + packet.lat) * np.pi / 360.0))
    tz = packet.alt
    t = np.array([tx, ty, tz])

    R = rotz_np(packet.yaw) @ roty_np(packet.pitch) @ rotx_np(packet.roll)
    return R, t


def T_from_R_t_np(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    R = R.reshape(3, 3)
    t = t.reshape(3, 1)
    return np.vstack((np.hstack([R, t]), [0, 0, 0, 1]))


def invert_pose_np(T: np.ndarray) -> np.ndarray:
    Tinv = np.copy(T)
    R, t = Tinv[:3, :3], Tinv[:3, 3]
    Tinv[:3, :3], Tinv[:3, 3] = R.T, -np.matmul(R.T, t)
    return Tinv


# ---------------------------------------------------------------------------
# torch side (model-side, differentiable)
# ---------------------------------------------------------------------------


def matmul3(A: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``A [B,3,3] @ M [B,3,n]`` as three broadcast multiply-adds in the
    operands' dtype: exact float32 on every device, whatever the TF32 and
    autocast settings, because no matmul kernel is involved."""
    return A[:, :, 0:1] * M[:, 0:1] + A[:, :, 1:2] * M[:, 1:2] + A[:, :, 2:3] * M[:, 2:3]


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles [B,3] (x,y,z) → rotation matrices [B,3,3], R = Rx @ Ry @ Rz."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    zeros = torch.zeros_like(z)
    ones = torch.ones_like(z)

    cz, sz = torch.cos(z), torch.sin(z)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], dim=1).reshape(-1, 3, 3)

    cy, sy = torch.cos(y), torch.sin(y)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], dim=1).reshape(-1, 3, 3)

    cx, sx = torch.cos(x), torch.sin(x)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], dim=1).reshape(-1, 3, 3)

    return matmul3(matmul3(xmat, ymat), zmat)


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)
    return row.expand(like.shape[0], 1, 4)


def pose_vec2mat(vec: torch.Tensor) -> torch.Tensor:
    """6-DoF vector [B,6] (tx,ty,tz,rx,ry,rz) → [B,4,4] SE(3)."""
    trans = vec[:, :3, None]
    rot_mat = euler2mat(vec[:, 3:])
    top = torch.cat([rot_mat, trans], dim=2)
    return torch.cat([top, _bottom_row(vec)], dim=1)


def invert_pose(T: torch.Tensor) -> torch.Tensor:
    """Invert [B,4,4] SE(3) poses."""
    Rt = T[:, :3, :3].transpose(-2, -1)
    new_t = -matmul3(Rt, T[:, :3, 3:])
    top = torch.cat([Rt, new_t], dim=2)
    return torch.cat([top, _bottom_row(T)], dim=1)
