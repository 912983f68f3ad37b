from .config import CfgNode, default_config, get_config, load_config, update_config
from .device import resolve_device
from .logging import create_logger

__all__ = [
    "CfgNode",
    "create_logger",
    "default_config",
    "get_config",
    "load_config",
    "resolve_device",
    "update_config",
]
