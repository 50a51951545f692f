from .build import (
    ScheduledLR,
    build_optimizer,
    multistep_lr_schedule,
    param_groups_by_name,
    poly_lr_schedule,
)

__all__ = [
    "ScheduledLR",
    "build_optimizer",
    "multistep_lr_schedule",
    "param_groups_by_name",
    "poly_lr_schedule",
]
