"""Load weights into the port's modules.

Two sources, one tree. The JAX package's variables are nested dicts
``{"params": {...}, "batch_stats": {...}}`` whose paths are the port's module
paths (``block1_0/conv1/kernel`` is ``block1_0.conv1.kernel``), so
:func:`from_jax_variables` copies them in without renaming. The upstream
``.pth`` checkpoints (a MinkowskiEngine ``state_dict``) are first mapped
onto that tree by :func:`convert_state_dict`, the key map of
``canonicalvoting_tpu/utils/torch_convert.py``:

  conv0p1s1.kernel (K, Cin, Cout)  -> conv0p1s1/kernel
  bn0.bn.{weight,bias}             -> bn0/{scale,bias}
  bn0.bn.running_{mean,var}        -> batch_stats bn0/{mean,var}
  block1.0.conv1.kernel            -> block1_0/conv1/kernel
  block1.0.downsample.0.kernel     -> block1_0/downsample_conv/kernel
  block1.0.downsample.1.bn.*       -> block1_0/downsample_norm/*
  final.{kernel,bias}              -> final/{kernel,bias}

MinkowskiEngine stores kernels (K, Cin, Cout) with x-fastest offsets, as the
port does, so they copy without permutation; k=1 kernels are stored
(Cin, Cout) and gain their leading K=1 axis.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch


def _leaves(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def from_jax_variables(model: torch.nn.Module, params: Dict,
                       batch_stats: Dict) -> torch.nn.Module:
    """Copy a JAX variables tree (numpy arrays) into ``model``; every
    parameter and buffer of the model must be covered, and nothing else."""
    state = {name: torch.from_numpy(np.array(v, np.float32))
             for name, v in _leaves(params)}
    state.update({name: torch.from_numpy(np.array(v, np.float32))
                  for name, v in _leaves(batch_stats)})
    model.load_state_dict(state, strict=True)
    return model


def _assign(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_state_dict(state_dict: Dict) -> Tuple[Dict, Dict]:
    """Upstream ``state_dict`` -> (params, batch_stats) numpy trees."""
    params: Dict = {}
    batch_stats: Dict = {}
    block_re = re.compile(r"^(block\d+)\.(\d+)\.(.*)$")
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        v = np.asarray(value.detach().cpu().numpy() if torch.is_tensor(value)
                       else value, np.float32)
        m = block_re.match(key)
        if m:
            module, rest = f"{m.group(1)}_{m.group(2)}", m.group(3)
        else:
            module, _, rest = key.partition(".")
        rest = rest.replace("downsample.0", "downsample_conv")
        rest = rest.replace("downsample.1", "downsample_norm")
        parts = rest.split(".")
        if "bn" in parts:
            path = [module] + [p for p in parts[:-1] if p != "bn"]
            leaf = parts[-1]
            if leaf in ("weight", "bias"):
                _assign(params, path + ["scale" if leaf == "weight" else "bias"], v)
            elif leaf in ("running_mean", "running_var"):
                _assign(batch_stats, path + [leaf[len("running_"):]], v)
            else:
                raise KeyError(f"unrecognized checkpoint key: {key}")
            continue
        path = [module] + parts[:-1]
        if parts[-1] == "kernel":
            _assign(params, path + ["kernel"], v[None] if v.ndim == 2 else v)
        elif parts[-1] == "bias":
            _assign(params, path + ["bias"], v)
        else:
            raise KeyError(f"unrecognized checkpoint key: {key}")
    return params, batch_stats


def load_pth(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load an upstream ``.pth`` checkpoint into ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_jax_variables(model, *convert_state_dict(sd))
