"""Picklable wrappers for closures and lambdas sent to worker threads or
processes: the port's copy of ``simpledepthestimation_tpu/utils/serialize.py``
(``cloudpickle`` where it is installed, else ``pickle``, which rejects lambdas)."""

from __future__ import annotations

import pickle
from typing import Any, Callable

try:
    import cloudpickle

    _dumps, _loads = cloudpickle.dumps, cloudpickle.loads
except ImportError:
    _dumps, _loads = pickle.dumps, pickle.loads


class PicklableWrapper:
    """Wrap a callable so that it pickles through ``cloudpickle``."""

    def __init__(self, obj: Callable):
        self._obj = obj

    def __reduce__(self):
        return (_unpickle_wrapped, (_dumps(self._obj),))

    def __call__(self, *args, **kwargs) -> Any:
        return self._obj(*args, **kwargs)

    def __getattr__(self, attr: str) -> Any:
        if attr != "_obj":
            return getattr(self._obj, attr)
        return super().__getattribute__(attr)


def _unpickle_wrapped(payload: bytes) -> PicklableWrapper:
    return PicklableWrapper(_loads(payload))
