from .build import DATASET_REGISTRY, DatasetBase, build_test_loader, build_train_loader
from .preprocess import PREPROCESS_REGISTRY, Preprocess, build_preprocess
from . import datasets  # noqa: F401  (registers datasets)

__all__ = [
    "DATASET_REGISTRY",
    "DatasetBase",
    "build_train_loader",
    "build_test_loader",
    "PREPROCESS_REGISTRY",
    "Preprocess",
    "build_preprocess",
]
