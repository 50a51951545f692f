"""Config version compatibility: upgrade/downgrade between schema versions.

Parity with reference detectron2/config/compat.py:33-229: configs carry a
``VERSION``; ``upgrade_config``/``downgrade_config`` walk per-version
converters, and ``guess_version`` infers the version of an unversioned file
from marker keys. The current schema is version 2 (same numbering as the
reference so its yaml files load unchanged); version 1 predates the split
DATASETS.{TRAIN,TEST} subtrees.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from .config import CfgNode

logger = logging.getLogger(__name__)

LATEST_VERSION = 2


def upgrade_config(cfg: CfgNode, to_version: Optional[int] = None) -> CfgNode:
    cfg = cfg.clone()
    if to_version is None:
        to_version = LATEST_VERSION
    assert cfg.VERSION <= to_version, (
        f"Cannot upgrade from v{cfg.VERSION} to v{to_version}"
    )
    for k in range(cfg.VERSION, to_version):
        converter = globals()[f"ConverterV{k + 1}"]
        converter.upgrade(cfg)
        cfg.VERSION = k + 1
    return cfg


def downgrade_config(cfg: CfgNode, to_version: int) -> CfgNode:
    cfg = cfg.clone()
    assert cfg.VERSION >= to_version, (
        f"Cannot downgrade from v{cfg.VERSION} to v{to_version}"
    )
    for k in range(cfg.VERSION, to_version, -1):
        converter = globals()[f"ConverterV{k}"]
        converter.downgrade(cfg)
        cfg.VERSION = k - 1
    return cfg


def guess_version(cfg: CfgNode, filename: str = "") -> int:
    """Infer the schema version of an unversioned config."""
    if "VERSION" in cfg:
        return int(cfg.VERSION)

    def has(name: str) -> bool:
        node = cfg
        for p in name.split("."):
            if p not in node:
                return False
            node = node[p]
        return True

    if has("DATASETS.TRAIN.NAME") or has("DATASETS.TEST.NAME"):
        version = 2
    else:
        version = 1
    logger.warning(f"Config '{filename}' has no VERSION; assuming v{version}")
    return version


class _RenameConverter:
    """Converter defined by a list of (old, new) key renames."""

    RENAME: List = []

    @classmethod
    def upgrade(cls, cfg: CfgNode) -> None:
        for old, new in cls.RENAME:
            _rename(cfg, old, new)

    @classmethod
    def downgrade(cls, cfg: CfgNode) -> None:
        for old, new in cls.RENAME:
            _rename(cfg, new, old)


def _get(cfg, path):
    node = cfg
    for p in path.split("."):
        node = node[p]
    return node


def _set(cfg, path, value):
    parts = path.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node:
            node[p] = CfgNode()
        node = node[p]
    node[parts[-1]] = value


def _del(cfg, path):
    parts = path.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node[p]
    del node[parts[-1]]


def _rename(cfg, old, new):
    try:
        value = _get(cfg, old)
    except KeyError:
        return
    _set(cfg, new, value)
    _del(cfg, old)


class ConverterV2(_RenameConverter):
    """v1 → v2: flat DATASETS keys split into TRAIN/TEST subtrees."""

    RENAME = [
        ("DATASETS.NAME", "DATASETS.TRAIN.NAME"),
        ("DATASETS.SPLIT", "DATASETS.TRAIN.SPLIT"),
        ("DATASETS.DATA_ROOT", "DATASETS.TRAIN.DATA_ROOT"),
        ("DATASETS.IMG_WIDTH", "DATASETS.TRAIN.IMG_WIDTH"),
        ("DATASETS.IMG_HEIGHT", "DATASETS.TRAIN.IMG_HEIGHT"),
    ]
