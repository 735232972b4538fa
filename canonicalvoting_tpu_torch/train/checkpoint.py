"""Read the JAX package's training checkpoints (``.ckpt``).

The JAX package writes ``flax.serialization.to_bytes({"epoch": int,
"state": TrainState(params, batch_stats, opt_state, step)})``
(``canonicalvoting_tpu/train/checkpoint.py:save_checkpoint``): msgpack of
the state dict, with flax's extension types for arrays. The port reads it
with a decoder of its own, needing neither flax nor msgpack. The format,
as flax's ``serialization.py`` defines it:

  * msgpack maps, arrays, str, bin, ints, floats, nil and bool; maps decode
    to dicts, arrays to lists;
  * ext type 1, an ndarray, and ext type 3, a numpy scalar: each payload is
    itself msgpack of ``(shape, dtype name, C-order bytes)``;
  * an array over flax's ``MAX_CHUNK_SIZE`` bytes is a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
    "chunks": {"0": flat chunk, ...}}``.

Leaves come back as numpy arrays and scalars, except ``bfloat16`` ones,
which numpy lacks: those are ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

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
