from .build import PREPROCESS_REGISTRY, Preprocess, build_preprocess
from . import loading  # noqa: F401  (registers ops)
from . import augmentation  # noqa: F401
from . import formatting  # noqa: F401

__all__ = ["PREPROCESS_REGISTRY", "Preprocess", "build_preprocess"]
