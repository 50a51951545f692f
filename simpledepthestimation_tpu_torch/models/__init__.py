from .build import (
    META_ARCH_REGISTRY,
    DEPTH_NET_REGISTRY,
    POSE_NET_REGISTRY,
    build_model,
    build_depth_net,
    build_pose_net,
)

# importing registers the components
from . import depth_nets  # noqa: F401
from . import google_resnet  # noqa: F401
from . import pose_nets  # noqa: F401
from . import meta_arch  # noqa: F401
from . import motion_meta_arch  # noqa: F401
from . import losses  # noqa: F401
from .motion_meta_arch import make_schedule_fn

__all__ = [
    "META_ARCH_REGISTRY",
    "DEPTH_NET_REGISTRY",
    "POSE_NET_REGISTRY",
    "build_model",
    "build_depth_net",
    "build_pose_net",
    "make_schedule_fn",
]
