from .config import CfgNode, get_cfg, global_cfg, set_global_cfg, load_yaml_with_base
from .instantiate import instantiate, configurable

__all__ = [
    "CfgNode",
    "get_cfg",
    "global_cfg",
    "set_global_cfg",
    "load_yaml_with_base",
    "instantiate",
    "configurable",
]
