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
from . import pose_nets  # noqa: F401
from . import meta_arch  # noqa: F401
from . import losses  # noqa: F401

__all__ = [
    "META_ARCH_REGISTRY",
    "DEPTH_NET_REGISTRY",
    "POSE_NET_REGISTRY",
    "build_model",
    "build_depth_net",
    "build_pose_net",
]
