"""Load weights into the port's modules.

Three sources, one tree, which the dense ``DenseMinkUNet`` and the sparse
``MinkUNetBase`` share, and the way back: :func:`to_jax_variables` gives a
model's weights as the JAX tree and :func:`reference_state_dict_template`
that tree in the upstream layout. The JAX package's variables are nested dicts
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
(Cin, Cout) and gain their leading K=1 axis. The JAX package's own training
checkpoints (``.ckpt``, read by ``train/checkpoint.py``) hold that tree
already, under their state's ``params`` and ``batch_stats``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from canonicalvoting_tpu_torch.data.geometry import NAME2CATNAME
from canonicalvoting_tpu_torch.models.dense_unet import DenseMinkUNet


def flatten(tree: Dict, prefix: str = ""):
    """(dotted path, leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def nest(flat: Dict) -> Dict:
    """Dotted paths -> the nested dict (the inverse of :func:`flatten`)."""
    tree: Dict = {}
    for name, v in flat.items():
        _assign(tree, name.split("."), v)
    return tree


def _f32(v) -> torch.Tensor:
    if torch.is_tensor(v):  # bfloat16 leaves of a .ckpt
        return v.float()
    return torch.from_numpy(np.array(v, np.float32))


def jax_state_dict(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """A JAX variables tree (numpy arrays) as the port's float32 state dict."""
    state = {name: _f32(v) for name, v in flatten(params)}
    state.update({name: _f32(v) for name, v in flatten(batch_stats)})
    return state


def from_jax_variables(model: torch.nn.Module, params: Dict,
                       batch_stats: Dict) -> torch.nn.Module:
    """Copy a JAX variables tree (numpy arrays) into ``model``; every
    parameter and buffer of the model must be covered, and nothing else."""
    model.load_state_dict(jax_state_dict(params, batch_stats), strict=True)
    return model


def to_jax_variables(model: torch.nn.Module) -> Dict:
    """The model's weights as a JAX variables tree of float32 numpy arrays:
    ``params`` from its parameters, ``batch_stats`` from its buffers (the BN
    running statistics), under their module paths."""
    def host(t):
        return t.detach().float().cpu().numpy()

    return {"params": nest({n: host(t) for n, t in model.named_parameters()}),
            "batch_stats": nest({n: host(t) for n, t in model.named_buffers()})}


def reference_state_dict_template(variables: Dict) -> Dict[str, np.ndarray]:
    """A JAX variables tree in the upstream (MinkowskiEngine) state-dict
    layout, numpy values: the inverse of :func:`convert_state_dict`, as the
    JAX package's ``utils/torch_convert.py`` maps it."""
    out = {}

    def is_norm(prefix):
        stripped = prefix.rstrip(".")
        last = stripped.split(".")[-1]
        return (last.startswith(("bn", "norm", "bntr"))
                or stripped.endswith("downsample.1"))

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                m = re.match(r"^(block\d+)_(\d+)$", k)
                mod = f"{m.group(1)}.{m.group(2)}" if m else k
                mod = mod.replace("downsample_conv", "downsample.0")
                mod = mod.replace("downsample_norm", "downsample.1")
                walk(v, prefix + mod + ".")
                continue
            v = np.asarray(v)
            if k in ("scale", "bias") and is_norm(prefix):
                out[prefix + "bn." + ("weight" if k == "scale" else "bias")] = v
            elif k in ("mean", "var"):
                out[prefix + "bn.running_" + k] = v
            elif k == "kernel":
                out[prefix + "kernel"] = v[0] if v.shape[0] == 1 else v
            else:
                out[prefix + k] = v

    walk(variables.get("params", {}), "")
    walk(variables.get("batch_stats", {}), "")
    return out


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
    """Load an upstream ``.pth`` checkpoint into ``model`` (a
    ``DenseMinkUNet`` or a ``MinkUNetBase``: the same tree). The SUN RGB-D
    checkpoint nests its state dict under ``model_state_dict``; that layout
    is unwrapped, as the JAX package's ``load_torch_checkpoint`` does."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return from_jax_variables(model, *convert_state_dict(sd))


def load_ckpt(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the params and batch statistics of a JAX package ``.ckpt``."""
    from canonicalvoting_tpu_torch.train.checkpoint import read_checkpoint

    state, _ = read_checkpoint(path)
    return from_jax_variables(model, state["params"], state["batch_stats"])


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """An upstream ``.pth`` or a JAX package ``.ckpt``, by its suffix."""
    if path.endswith(".pth"):
        return load_pth(model, path)
    return load_ckpt(model, path)


def category_state_dicts(model, categories: List[str],
                         pretrained_dir: Optional[str] = None
                         ) -> List[Dict[str, torch.Tensor]]:
    """State dicts of the per-category models of ``model``'s plan, in
    ``categories`` order, looked for in ``pretrained_dir`` as the JAX
    ``eval_separate.py`` looks: the upstream ``<wnid>.pth`` (named through
    ``NAME2CATNAME``), then the JAX package's ``<category>.ckpt``, and,
    where there is neither, random weights from
    ``torch.manual_seed(index)``."""
    catname2name = {v: k for k, v in NAME2CATNAME.items()}
    out = []
    for i, category in enumerate(categories):
        torch.manual_seed(i)
        m = DenseMinkUNet(**model.config())
        if pretrained_dir is not None:
            for path in (
                    os.path.join(pretrained_dir, f"{catname2name[category]}.pth"),
                    os.path.join(pretrained_dir, f"{category}.ckpt")):
                if os.path.exists(path):
                    load_weights(m, path)
                    break
        out.append({k: v.detach() for k, v in m.state_dict().items()})
    return out
