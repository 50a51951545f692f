"""Lazy ``_target_`` instantiation and the ``configurable`` decorator.

Re-designs of the reference's hydra-style instantiation
(reference detectron2/config/instantiate.py) and ``configurable``
(reference detectron2/config/config.py:115-258): classes/functions may be
constructed either from explicit kwargs or from a ``CfgNode`` via a
``from_config`` classmethod.
"""

from __future__ import annotations

import functools
import importlib
import inspect
from typing import Any

from .config import CfgNode


def locate(name: str) -> Any:
    """Import a dotted-path object, e.g. ``package.module.ClassName``."""
    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        obj = mod
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"Cannot locate object {name!r}")


def instantiate(cfg: Any) -> Any:
    """Recursively instantiate ``_target_`` dicts."""
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(c) for c in cfg)
    if isinstance(cfg, dict):
        if "_target_" in cfg:
            kwargs = {k: instantiate(v) for k, v in cfg.items() if k != "_target_"}
            target = cfg["_target_"]
            if isinstance(target, str):
                target = locate(target)
            return target(**kwargs)
        return {k: instantiate(v) for k, v in cfg.items()}
    return cfg


def _called_with_cfg(*args, **kwargs) -> bool:
    if len(args) and isinstance(args[0], (CfgNode, dict)) and not kwargs:
        return isinstance(args[0], CfgNode) or "cfg" in kwargs
    if isinstance(kwargs.pop("cfg", None), CfgNode):
        return True
    return len(args) > 0 and isinstance(args[0], CfgNode)


def configurable(init_func=None, *, from_config=None):
    """Decorator making a function/``__init__`` callable with a cfg.

    With a cfg argument, ``from_config(cfg, ...)`` produces the explicit
    kwargs; otherwise the call passes through unchanged.
    """
    if init_func is not None:
        assert inspect.isfunction(init_func) and from_config is None

        @functools.wraps(init_func)
        def wrapped(self, *args, **kwargs):
            from_cfg = getattr(type(self), "from_config", None)
            if from_cfg is None:
                raise AttributeError("@configurable class requires a from_config classmethod")
            if _called_with_cfg(*args, **kwargs):
                explicit = from_cfg(*args, **kwargs)
                init_func(self, **explicit)
            else:
                init_func(self, *args, **kwargs)

        return wrapped

    assert from_config is not None

    def wrapper(orig_func):
        @functools.wraps(orig_func)
        def wrapped(*args, **kwargs):
            if _called_with_cfg(*args, **kwargs):
                explicit = from_config(*args, **kwargs)
                return orig_func(**explicit)
            return orig_func(*args, **kwargs)

        wrapped.from_config = from_config
        return wrapped

    return wrapper
