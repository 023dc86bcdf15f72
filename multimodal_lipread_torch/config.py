"""YAML configuration with dot-path access (counterpart of the JAX package's
``config.py``).

PyYAML is imported only where a file is read, so code that builds
its configuration with :meth:`Config.from_dict` needs no YAML package.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

# PyYAML (YAML 1.1) resolves floats only when the mantissa has a '.', so
# ``1e-3`` loads as a string; such scalars are turned into floats after
# parsing.
_SCI_FLOAT = re.compile(r"^[-+]?(\d+(\.\d*)?|\.\d+)[eE][-+]?\d+$")


def coerce_yaml_scalar(value: Any) -> Any:
    """float-ify scientific-notation strings PyYAML left unparsed."""
    if isinstance(value, str) and _SCI_FLOAT.match(value):
        return float(value)
    return value


def _coerce_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _coerce_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_tree(v) for v in node]
    return coerce_yaml_scalar(node)


class Config:
    """Nested-dict configuration with dot-notation ``get``.

    ``Config(path)`` loads a YAML file; ``Config.from_dict(d)`` wraps an
    existing dictionary.
    """

    def __init__(self, config_path: Optional[str] = None, *, _data: Optional[Dict[str, Any]] = None):
        self.config_path = config_path
        if _data is not None:
            self.config = _data
        else:
            if config_path is None:
                raise ValueError("Config requires a path or _data dict")
            self.config = self._load_config()

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Config":
        return cls(_data=dict(data))

    def _load_config(self) -> Dict[str, Any]:
        import yaml

        if not os.path.exists(self.config_path):
            raise FileNotFoundError(f"Config file not found: {self.config_path}")
        with open(self.config_path, "r") as f:
            config = yaml.safe_load(f)
        return _coerce_tree(config) or {}

    def get(self, key: str, default: Optional[Any] = None) -> Any:
        """Get a value by dot-path key (e.g. ``model.name``)."""
        value: Any = self.config
        for k in key.split("."):
            if isinstance(value, dict) and k in value:
                value = value[k]
            else:
                return default
        return value

    def set(self, key: str, value: Any) -> None:
        """Set a value by dot-path key, creating intermediate dicts."""
        keys = key.split(".")
        node = self.config
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def get_all(self) -> Dict[str, Any]:
        return self.config

    def save(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.config, f, sort_keys=False)


def load_config(config_path: str) -> Config:
    """Load a YAML configuration file."""
    return Config(config_path)
