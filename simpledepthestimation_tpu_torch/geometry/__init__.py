from .camera import (
    scale_intrinsics,
    inv_intrinsics,
    resize_img,
    resize_img_avgpool,
    image_grid,
    img_to_points,
    points_to_img,
    view_synthesis,
    view_synthesis_v2,
)
from .pose import (
    euler2mat,
    pose_vec2mat,
    invert_pose,
    pose_from_oxts_packet_np,
    T_from_R_t_np,
    invert_pose_np,
)

__all__ = [
    "scale_intrinsics",
    "inv_intrinsics",
    "resize_img",
    "resize_img_avgpool",
    "image_grid",
    "img_to_points",
    "points_to_img",
    "view_synthesis",
    "view_synthesis_v2",
    "euler2mat",
    "pose_vec2mat",
    "invert_pose",
    "pose_from_oxts_packet_np",
    "T_from_R_t_np",
    "invert_pose_np",
]
