"""Name → object registry used by all pluggable components.

Equivalent capability to the reference's fvcore Registry
(reference detectron2/utils/registry.py): datasets, preprocess ops,
depth nets, pose nets, meta-architectures, and evaluators all register
under string names referenced from yaml configs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(f"'{name}' already registered in {self._name} registry")
        self._obj_map[name] = obj

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None) -> Any:
        if obj is None:
            # decorator usage
            def deco(fn_or_cls):
                self._do_register(name or fn_or_cls.__name__, fn_or_cls)
                return fn_or_cls

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"'{name}' not found in {self._name} registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()
