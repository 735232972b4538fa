"""The configuration keys the port's evaluators and datasets read.

A subset of ``canonicalvoting_tpu/config.py`` with the same names and
defaults (upstream ``config/config.yaml``): the ``data.*`` paths,
``scannet_res``, ``log_scale``, ``use_xyz``, ``category``, ``augment``,
``augment_color``, ``in_channels``, ``tpu.max_boxes`` and
``tpu.conv_dtype``. Values come from an optional YAML file, then from
hydra-style ``key=value`` overrides, each cast to the type of the field it
sets. ``yaml`` is imported only when a file is given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class DataConfig:
    # upstream config/config.yaml:1-9
    scan2cad: str = "/path/to/full_annotations.json"
    scannet: str = "/data/ScanNetV2"
    train_split: str = "/path/to/scannetv2_train.txt"
    val_split: str = "/path/to/scannetv2_val.txt"
    train_segments: str = "/path/to/scan2cad/train/scan2cad_segments.pkl"
    val_segments: str = "/path/to/scan2cad/val/scan2cad_segments.pkl"
    gt_path: str = "/path/to/results_gt"
    scene_nn_root: str = "/path/to/scene_nn/root"


@dataclass
class TPUConfig:
    # the section keeps the JAX package's name so YAML files and overrides
    # (tpu.max_boxes=...) carry over unchanged
    max_boxes: int = 64
    conv_dtype: str = "bfloat16"


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    scannet_res: float = 0.03
    log_scale: bool = True
    augment_color: bool = False
    augment: bool = True
    use_xyz: bool = False
    category: str = "all"
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
                    continue  # keys the port does not read
    for ov in overrides or []:
        if "=" not in ov:
            continue
        key, _, value = ov.partition("=")
        _set(cfg, key.strip().lstrip("+"), value.strip())
    return cfg


def parse_cli(argv: list) -> tuple:
    """(yaml_path, overrides, categories): ``--config=<yaml>``, the
    ``key=value`` overrides, and the categories of the multirun sweep
    ``category=a,b,c -m`` (None without ``-m``)."""
    multirun = False
    overrides = []
    yaml_path = None
    for a in argv:
        if a in ("-m", "--multirun"):
            multirun = True
        elif a.startswith("--config="):
            yaml_path = a.split("=", 1)[1]
        else:
            overrides.append(a)
    categories = None
    if multirun:
        for ov in overrides:
            if ov.startswith("category="):
                categories = ov.split("=", 1)[1].split(",")
    return yaml_path, overrides, categories
