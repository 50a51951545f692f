from .resample import (
    resample_bilinear,
    grid_sample_bilinear,
    resampler_with_unstacked_warp,
)
from .pool import avg_pool, avg_pool_3x3_reflect, avg_pool_3x3_same, max_pool, reflect_pad_hw
from .photometric import photometric_map, photometric_map_plain
from .warp import warp_bilinear, warp_bilinear_plain

__all__ = [
    "resample_bilinear",
    "grid_sample_bilinear",
    "resampler_with_unstacked_warp",
    "avg_pool",
    "avg_pool_3x3_reflect",
    "avg_pool_3x3_same",
    "max_pool",
    "reflect_pad_hw",
    "photometric_map",
    "photometric_map_plain",
    "warp_bilinear",
    "warp_bilinear_plain",
]
