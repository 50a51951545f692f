"""Yaml-backed hierarchical config with ``_BASE_`` inheritance and dot-list overrides.

Standalone re-design of the reference's yacs/fvcore ``CfgNode``
(see reference detectron2/config/config.py:29-112): same user-facing behavior —
yaml files with ``_BASE_`` chains, ``KEY.SUBKEY VALUE`` CLI override lists,
freezing, attribute access — implemented standalone (no yacs/fvcore), with
*safe* yaml loading plus a literal-eval fallback for python-ish scalars such
as tuples (the reference uses unsafe loading for those).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"


def _maybe_literal(value: Any) -> Any:
    """Interpret python-container strings (e.g. ``"(15,)"``) the way the
    reference's unsafe yaml loading would. Restricted to tuple/list/dict
    syntax — quoted scalars like ``"18"`` must stay strings."""
    if isinstance(value, str) and value[:1] in ("(", "[", "{"):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    return value


class CfgNode(dict):
    """A dict with attribute access, recursive merge, and freeze support."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = self._to_node(v)

    @classmethod
    def _to_node(cls, value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return cls(value)
        if isinstance(value, list):
            return [cls._to_node(v) for v in value]
        return value

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = self._to_node(value)

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freezing ----------------------------------------------------------
    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo) -> "CfgNode":
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        return out

    def __reduce__(self):
        return (CfgNode, (dict(self),))

    # -- merging -----------------------------------------------------------
    def merge_from_other(self, other: "CfgNode") -> None:
        was_frozen = self.is_frozen()
        self.defrost()
        _merge_dicts(other, self)
        if was_frozen:
            self.freeze()

    def merge_from_file(self, cfg_filename: str, allow_new: bool = True) -> None:
        loaded = load_yaml_with_base(cfg_filename)
        self.merge_from_other(CfgNode(loaded))

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list must be key-value pairs, got {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            old = node.get(parts[-1], None)
            new = _maybe_literal(yaml.safe_load(value) if isinstance(value, str) else value)
            if old is not None and new is not None and not isinstance(new, type(old)):
                if isinstance(old, (tuple, list)) and isinstance(new, (tuple, list)):
                    new = type(old)(new)
                elif isinstance(old, float) and isinstance(new, int):
                    new = float(new)
                elif isinstance(old, bool) != isinstance(new, bool):
                    raise ValueError(f"Type mismatch for {key}: {type(old)} vs {type(new)}")
            node[parts[-1]] = CfgNode._to_node(new)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        def convert(v):
            if isinstance(v, CfgNode):
                return {k: convert(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(convert(x) for x in v)
            return v

        return convert(self)

    def dump(self) -> str:
        return yaml.safe_dump(_tuples_to_lists(self.to_dict()), sort_keys=True)


def _tuples_to_lists(obj):
    if isinstance(obj, dict):
        return {k: _tuples_to_lists(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tuples_to_lists(v) for v in obj]
    return obj


def _merge_dicts(src: Dict, dst: CfgNode) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), CfgNode):
            _merge_dicts(v, dst[k])
        else:
            dst[k] = CfgNode._to_node(_maybe_literal(v))


def load_yaml_with_base(filename: str) -> Dict[str, Any]:
    """Load a yaml file, recursively expanding the ``_BASE_`` key.

    Mirrors the inheritance behavior of the reference's fvcore loader
    (reference detectron2/config/config.py:39-52) with safe loading.
    """
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}

    if _BASE_KEY in cfg:
        base_file = cfg.pop(_BASE_KEY)
        if not os.path.isabs(base_file):
            base_file = os.path.join(os.path.dirname(filename), base_file)
        base = CfgNode(load_yaml_with_base(base_file))
        _merge_dicts(cfg, base)
        return base.to_dict()
    return cfg


def get_cfg() -> CfgNode:
    """Return a fresh copy of the default config tree."""
    from .defaults import _C

    return _C.clone()


_global_cfg = CfgNode()


def set_global_cfg(cfg: CfgNode) -> None:
    global _global_cfg
    _global_cfg.clear()
    _global_cfg.update(cfg)


global_cfg = _global_cfg
