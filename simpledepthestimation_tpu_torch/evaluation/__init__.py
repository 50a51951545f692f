from .evaluator import (
    EVALUATOR_REGISTRY,
    DatasetEvaluator,
    DatasetEvaluators,
    build_evaluator,
    inference_on_dataset,
)
from . import depth_evaluation  # noqa: F401  (registers evaluators)
from .depth_evaluation import garg_crop, eigen_crop, compute_errors

__all__ = [
    "EVALUATOR_REGISTRY",
    "DatasetEvaluator",
    "DatasetEvaluators",
    "build_evaluator",
    "inference_on_dataset",
    "garg_crop",
    "eigen_crop",
    "compute_errors",
]
