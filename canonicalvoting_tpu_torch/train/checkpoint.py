"""Training checkpoints (``.ckpt``) in the JAX package's format.

The JAX package writes ``flax.serialization.to_bytes({"epoch": int,
"state": TrainState(params, batch_stats, opt_state, step)})``
(``canonicalvoting_tpu/train/checkpoint.py:save_checkpoint``): msgpack of
the state dict, with flax's extension types for arrays. The port reads and
writes it with a decoder and an encoder of its own, needing neither flax
nor msgpack, so a checkpoint of either package resumes in the other. The
format, as flax's ``serialization.py`` defines it:

  * msgpack maps, arrays, str, bin, ints, floats, nil and bool; maps decode
    to dicts, arrays to lists;
  * ext type 1, an ndarray, and ext type 3, a numpy scalar: each payload is
    itself msgpack of ``(shape, dtype name, C-order bytes)``;
  * an array over flax's ``MAX_CHUNK_SIZE`` bytes is a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
    "chunks": {"0": flat chunk, ...}}``.

Leaves come back as numpy arrays and scalars, except ``bfloat16`` ones,
which numpy lacks: those are ``torch.bfloat16`` tensors. The encoder packs
as flax's ``msgpack_serialize`` does (map keys sorted, the smallest
msgpack form of each item, Python floats as doubles), byte for byte.

The port's train state (``train/steps.py:TrainState``) maps onto the JAX
package's: ``params`` and ``batch_stats`` are the model's parameters and
buffers under their module paths (``utils/weights.py``), ``step`` the
updates taken, and ``opt_state`` optax's ``inject_hyperparams(adam)`` (or
``adamw``) state: the outer ``count``, the ``hyperparams`` (``b1``,
``b2``, ``eps``, ``eps_root``, ``learning_rate``, and ``weight_decay`` for
AdamW), empty ``hyperparams_states``, and ``inner_state`` whose entry "0"
holds Adam's ``count``, ``mu`` and ``nu`` trees (torch's ``step``,
``exp_avg`` and ``exp_avg_sq``), then one empty state a further transform.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from canonicalvoting_tpu_torch.utils.weights import (
    flatten, from_jax_variables, nest, reference_state_dict_template,
    to_jax_variables)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width items: first byte -> struct format (big-endian)
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# sized items: first byte -> (kind, struct format of the size)
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an item")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def decode_all(self):
        value = self.value()
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} bytes after the "
                             "msgpack item")
        return value

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.map(b & 0x0f)
        if b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.number(_FIXED[b])
        if b in _FIXEXT:
            code = self.number(">b")
            return _ext(code, self.take(_FIXEXT[b]))
        if b not in _SIZED:
            raise ValueError(f"invalid msgpack byte 0x{b:02x}")
        kind, fmt = _SIZED[b]
        n = self.number(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        code = self.number(">b")
        return _ext(code, self.take(n))

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(payload: memoryview):
    shape, name, buf = _Decoder(payload).decode_all()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        a = _ndarray(payload)
        return a if torch.is_tensor(a) else a[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def _unchunk(tree):
    """Chunked-array maps back into arrays, everywhere in ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree of flax's ``msgpack_serialize`` output."""
    return _unchunk(_Decoder(data).decode_all())


def read_checkpoint(path: str) -> Tuple[Dict, int]:
    """(state tree, epoch) of a JAX ``.ckpt``: the state's ``params``,
    ``batch_stats``, ``opt_state`` and ``step`` as nested dicts."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        payload = msgpack_restore(data)
        return payload["state"], int(payload["epoch"])
    except (ValueError, KeyError, TypeError, struct.error) as e:
        raise ValueError(f"{path}: not a JAX package checkpoint ({e})") from e


# ---------------------------------------------------------------------------
# the writer

MAX_CHUNK_SIZE = 2 ** 30  # flax's: larger arrays are stored in chunks


def _uint_head(n: int, fix_base: int, fix_max: int, heads) -> bytes:
    """The header of a sized msgpack item: a fix form below ``fix_max``,
    else the first of ``heads`` ((byte, struct format, limit)) that fits."""
    if n < fix_max:
        return bytes([fix_base | n])
    for b, fmt, limit in heads:
        if n < limit:
            return bytes([b]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack item of {n} entries is too large")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARRAY = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))
_EXT = ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16), (0xc9, ">I", 1 << 32))
_FIXEXT_OF = {v: k for k, v in _FIXEXT.items()}


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for b, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                              (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                return bytes([b]) + struct.pack(fmt, v)
    for b, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                          (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
        if v >= -limit:
            return bytes([b]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


class _Encoder:
    def __init__(self):
        self.out = bytearray()

    def value(self, v) -> None:
        out = self.out
        if v is None:
            out.append(0xc0)
        elif isinstance(v, bool):
            out.append(0xc3 if v else 0xc2)
        elif isinstance(v, int):
            out += _int(v)
        elif isinstance(v, float):
            out += b"\xcb" + struct.pack(">d", v)
        elif isinstance(v, str):
            data = v.encode("utf-8")
            out += _uint_head(len(data), 0xa0, 32, _STR) + data
        elif isinstance(v, (bytes, bytearray, memoryview)):
            data = bytes(v)
            out += _uint_head(len(data), 0, 0, _BIN) + data
        elif isinstance(v, dict):
            out += _uint_head(len(v), 0x80, 16, _MAP)
            for k, x in v.items():
                self.value(k)
                self.value(x)
        elif isinstance(v, (list, tuple)):
            out += _uint_head(len(v), 0x90, 16, _ARRAY)
            for x in v:
                self.value(x)
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            self.ext(_EXT_NDARRAY, _ndarray_bytes(v))
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
        else:
            raise TypeError(f"cannot serialize {type(v).__name__}")

    def ext(self, code: int, data: bytes) -> None:
        if len(data) in _FIXEXT_OF:
            self.out.append(_FIXEXT_OF[len(data)])
        else:
            self.out += _uint_head(len(data), 0, 0, _EXT)
        self.out += struct.pack(">b", code) + data


def _ndarray_bytes(a) -> bytes:
    """flax's ndarray payload: msgpack of (shape, dtype name, C bytes)."""
    if torch.is_tensor(a):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            data = t.view(torch.int16).numpy().tobytes()
            return _pack((shape, name, data))
        a = t.numpy()
    return _pack((a.shape, a.dtype.name, a.tobytes("C")))


def _pack(tree) -> bytes:
    enc = _Encoder()
    enc.value(tree)
    return bytes(enc.out)


def _chunk_leaves(tree):
    """The tree with its maps' keys sorted (as the tree map flax passes it
    through sorts them) and arrays over MAX_CHUNK_SIZE bytes as flax's
    chunked-array maps."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        n = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        return {_CHUNKED: True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): flat[s:s + n] for i, s in
                           enumerate(range(0, flat.size, n))}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """flax's ``msgpack_serialize`` of a tree of dicts, numbers, strings and
    arrays (numpy, or torch tensors)."""
    return _pack(_chunk_leaves(tree))


def opt_state_tree(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                   ) -> Dict:
    """The optimizer's state in optax's ``inject_hyperparams(adam)`` (or
    ``adamw``) layout, its moments under the model's parameter paths."""
    group = optimizer.param_groups[0]
    adamw = isinstance(optimizer, torch.optim.AdamW)
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            m, v = st["exp_avg"], st["exp_avg_sq"]
        else:
            m = v = torch.zeros_like(p)
        mu[name] = m.detach().float().cpu().numpy()
        nu[name] = v.detach().float().cpu().numpy()
    b1, b2 = group["betas"]
    hyper = {"b1": b1, "b2": b2, "eps": group["eps"], "eps_root": 0.0,
             "learning_rate": group["lr"]}
    if adamw:
        hyper["weight_decay"] = group["weight_decay"]
    inner = {"0": {"count": np.asarray(count, np.int32), "mu": nest(mu),
                   "nu": nest(nu)}, "1": {}}
    if adamw:
        inner["2"] = {}
    return {"count": np.asarray(count, np.int32),
            "hyperparams": {k: np.asarray(v, np.float32)
                            for k, v in hyper.items()},
            "hyperparams_states": {}, "inner_state": inner}


def load_opt_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   tree: Dict) -> None:
    """Set the optimizer's moments, step count and learning rate from an
    optax ``inject_hyperparams(adam)`` / ``adamw`` state tree."""
    inner = tree["inner_state"]["0"]
    count = int(np.asarray(inner["count"]))
    mu, nu = dict(flatten(inner["mu"])), dict(flatten(inner["nu"]))
    for name, p in model.named_parameters():
        optimizer.state.pop(p, None)
        if count:
            optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.asarray(mu[name], np.float32)).to(p),
                "exp_avg_sq": torch.as_tensor(np.asarray(nu[name], np.float32)).to(p)}
    lr = float(np.asarray(tree["hyperparams"]["learning_rate"]))
    for group in optimizer.param_groups:
        group["lr"] = lr


def train_state_tree(state) -> Dict:
    """A ``TrainState`` as the JAX package's train-state tree."""
    variables = to_jax_variables(state.model)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": opt_state_tree(state.model, state.optimizer),
            "step": np.asarray(state.step, np.int32)}


def save_checkpoint(path: str, state, epoch: int) -> None:
    """Write ``{"epoch", "state"}`` as the JAX package does, through a
    ``.tmp`` file renamed into place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = msgpack_serialize({"epoch": int(epoch),
                              "state": train_state_tree(state)})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state):
    """Load a checkpoint of either package into ``state`` (its model and
    optimizer, in place); returns (state, epoch)."""
    tree, epoch = read_checkpoint(path)
    from_jax_variables(state.model, tree["params"], tree["batch_stats"])
    load_opt_state(state.model, state.optimizer, tree["opt_state"])
    state.step = int(np.asarray(tree["step"]))
    return state, epoch


def latest_checkpoint(directory: str, prefix: str = "epoch") -> Optional[str]:
    """The ``<prefix><epoch>.ckpt`` of ``directory`` with the largest
    epoch, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".ckpt"):
            try:
                e = int(name[len(prefix):-5])
            except ValueError:
                continue
            if e > best_epoch:
                best, best_epoch = os.path.join(directory, name), e
    return best


def export_torch_style(path: str, model: torch.nn.Module) -> None:
    """Write the model's weights in the upstream checkpoint format: a
    ``torch.save``d MinkowskiEngine-layout state dict (upstream
    train_joint.py:291)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          reference_state_dict_template(to_jax_variables(model)).items()}
    torch.save(sd, path)
