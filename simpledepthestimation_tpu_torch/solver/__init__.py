from .build import (
    ScheduledLR,
    build_optimizer,
    frozen_parameter_names,
    multistep_lr_schedule,
    param_groups_by_name,
    poly_lr_schedule,
)

__all__ = [
    "ScheduledLR",
    "build_optimizer",
    "frozen_parameter_names",
    "multistep_lr_schedule",
    "param_groups_by_name",
    "poly_lr_schedule",
]
