"""The configuration keys the joint evaluator reads.

The subset of ``canonicalvoting_tpu/config.py`` that ``eval_joint`` uses, with
the same names and defaults (upstream ``config/config.yaml``): ``scannet_res``,
``log_scale``, ``use_xyz``, ``in_channels``, ``tpu.max_boxes`` and
``tpu.conv_dtype``. Values come from an optional YAML file, then from
hydra-style ``key=value`` overrides. ``yaml`` is imported only when a file
is given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class TPUConfig:
    # the section keeps the JAX package's name so YAML files and overrides
    # (tpu.max_boxes=...) carry over unchanged
    max_boxes: int = 64
    conv_dtype: str = "bfloat16"


@dataclass
class Config:
    scannet_res: float = 0.03
    log_scale: bool = True
    use_xyz: bool = False
    tpu: TPUConfig = field(default_factory=TPUConfig)

    @property
    def in_channels(self) -> int:
        return 6 if self.use_xyz else 3


def _set(obj, path: str, value) -> None:
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    if not hasattr(obj, name):
        raise KeyError(f"unknown config key: {path}")
    current = getattr(obj, name)
    if isinstance(value, str):
        if isinstance(current, bool):
            value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(current, (int, float)):
            value = type(current)(value)
    setattr(obj, name, value)


def _flatten(d: dict, prefix: str = ""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[list] = None) -> Config:
    """Defaults, then the YAML file's known keys, then ``key=value``
    overrides."""
    cfg = Config()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            for key, v in _flatten(yaml.safe_load(f) or {}):
                try:
                    _set(cfg, key, v)
                except (KeyError, AttributeError):
                    continue  # keys the joint evaluator does not read
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        _set(cfg, key.strip().lstrip("+"), value.strip())
    return cfg
