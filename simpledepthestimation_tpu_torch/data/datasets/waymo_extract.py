"""Pure numpy math of Waymo frame extraction: the port's own copy of
``simpledepthestimation_tpu/data/datasets/waymo_extract.py`` (the same
functions, bit for bit), so that the port can write and read an extracted
tree without the JAX package.

The extraction tool (tools/extract_waymo_data.py) is thin tf/waymo-od glue
around these functions: the lidar→camera projection, the depth image and the
infos index (reference tools/extract_waymo_data.py:33-113).

Conventions (matching the reference):

- Waymo camera extrinsics map CAMERA → VEHICLE frame; the camera frame is
  x-forward/y-left/z-up, so projecting needs the axis permutation
  ``AXIS_SWAP`` into the optical frame (z-forward) —
  reference extract_waymo_data.py:29-38.
- Stored depth is the CAMERA-FRAME Z (forward depth), not Euclidean range —
  reference writes ``proj_ours[:, 2]`` (extract_waymo_data.py:106-108).
- Depth pngs are uint16 ×255 (consumed by LoadDepth's /255 —
  reference data/preprocess/loading.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# vehicle x-forward/y-left/z-up → optical z-forward/x-right/y-down
# (reference extract_waymo_data.py:29-32)
AXIS_SWAP = np.array(
    [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
)


def intrinsic_matrix4(f_u: float, f_v: float, c_u: float, c_v: float) -> np.ndarray:
    """Waymo calibration intrinsic[:4] → 4×4 projection matrix
    (reference extract_waymo_data.py:80-84; distortion terms are unused)."""
    return np.array(
        [[f_u, 0, c_u, 0], [0, f_v, c_v, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float64,
    )


def project_points_to_camera(
    points_vehicle: np.ndarray, extrinsic: np.ndarray, intrinsic4: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Project vehicle-frame lidar points into a camera.

    points_vehicle: [N,3]; extrinsic: 4×4 camera→vehicle; intrinsic4: 4×4.
    Returns (u, v, depth) — pixel coordinates and camera-frame forward
    depth. Matches reference ``points2img(pts, inv(extrinsic),
    intrinsic @ T)`` (extract_waymo_data.py:33-38,99)."""
    M = intrinsic4 @ AXIS_SWAP @ np.linalg.inv(extrinsic)
    proj = (M[:3, :3] @ points_vehicle.T + M[:3, [3]]).T  # [N,3]
    depth = proj[:, 2]
    u = proj[:, 0] / depth
    v = proj[:, 1] / depth
    return u, v, depth


def unproject_from_camera(
    u: np.ndarray, v: np.ndarray, depth: np.ndarray,
    extrinsic: np.ndarray, intrinsic4: np.ndarray,
) -> np.ndarray:
    """Inverse of :func:`project_points_to_camera` (round-trip oracle)."""
    M = intrinsic4 @ AXIS_SWAP @ np.linalg.inv(extrinsic)
    Minv = np.linalg.inv(M)
    homog = np.stack([u * depth, v * depth, depth], axis=-1)  # [N,3]
    return (Minv[:3, :3] @ homog.T + Minv[:3, [3]]).T


def scatter_depth_image(
    height: int, width: int, xs: np.ndarray, ys: np.ndarray, depth: np.ndarray
) -> np.ndarray:
    """Assemble a sparse depth image from projection indices + depths
    (reference extract_waymo_data.py:106-108). Out-of-bounds or
    non-positive-depth returns are dropped (defensive: the waymo cp indices
    are valid by construction)."""
    img = np.zeros((height, width), np.float32)
    xs = np.asarray(xs, np.int64)
    ys = np.asarray(ys, np.int64)
    ok = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height) & (depth > 0)
    img[ys[ok], xs[ok]] = depth[ok]
    return img


def encode_depth_png(depth: np.ndarray) -> np.ndarray:
    """float32 meters → uint16 ×255 png payload (reference
    extract_waymo_data.py:108, utils/file_utils.py:5-8)."""
    return (depth * 255.0).astype(np.uint16)


def decode_depth_png(png: np.ndarray) -> np.ndarray:
    """uint16 png payload → float32 meters (LoadDepth's /255)."""
    return png.astype(np.float32) / 255.0


def build_frame_info(
    segment: str, frame_idx: int, rel_dir: str, calib: Dict[str, Dict[str, np.ndarray]]
) -> Dict:
    """One infos-frame record in the layout WaymoDepth consumes
    (data/datasets/waymo.py)."""
    return {
        "segment": segment,
        "frame": int(frame_idx),
        "rel_dir": rel_dir,
        "calib": calib,
    }


def assemble_infos(per_segment_frames: Sequence[List[Dict]]) -> Dict:
    """Flatten per-segment frame lists into the infos.pkl payload,
    ordered by (segment, frame) so context windows index consecutively."""
    frames = [fr for seg in per_segment_frames for fr in seg]
    frames.sort(key=lambda fr: (fr["segment"], fr["frame"]))
    return {"frames": frames}
