from . import kitti  # noqa: F401  (registers KittiDepthV2)
from . import synthetic  # noqa: F401  (registers SyntheticDepth)
from . import waymo  # noqa: F401  (registers WaymoDepth)
