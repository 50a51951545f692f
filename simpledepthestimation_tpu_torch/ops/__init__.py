from .resample import (
    resample_bilinear,
    resample_bilinear_image_grad,
    grid_sample_bilinear,
    resampler_with_unstacked_warp,
)
from .pool import avg_pool, avg_pool_3x3_reflect, avg_pool_3x3_same, max_pool, reflect_pad_hw
from .photometric import photometric_map, photometric_map_plain
from .warp import warp_bilinear, warp_bilinear_plain, warp_image_grad, warp_image_grad_plain

__all__ = [
    "resample_bilinear",
    "resample_bilinear_image_grad",
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
    "warp_image_grad",
    "warp_image_grad_plain",
]
