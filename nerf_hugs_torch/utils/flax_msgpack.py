"""Read and write flax msgpack checkpoints without flax or msgpack.

flax.serialization.msgpack_serialize writes a tree of maps with msgpack's
str, bin, int, float, bool, nil and array values, and two extension types
of its own: ext 1, an ndarray, whose payload is the msgpack of (shape,
dtype name, C-order bytes), and ext 3, a numpy scalar (the same payload,
read back as a 0-d array's item). msgpack arrays come back as lists, as
flax's restore gives them. Ext 2 (a Python complex) and arrays that flax
split into `__msgpack_chunked_array__` pieces (leaves above 1 GiB) are
refused by name. bfloat16 arrays come back as float32, exactly.

msgpack_serialize writes the bytes flax's msgpack_serialize writes for a
tree of dicts (keys sorted, as flax's copy of the tree leaves them),
lists, Python scalars, numpy arrays and numpy scalars, in msgpack's
smallest encoding of each value; it refuses what the reader refuses.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Any, Tuple

import numpy as np

_CHECKPOINT_RE = re.compile(r"^checkpoint_(\d+)$")
# flax splits array leaves above this many bytes into chunks.
_MAX_LEAF_BYTES = 1 << 30


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        simple = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                  0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in simple:
            return self.unpack(simple[b])
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack byte 0x{b:02x} is not a value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("__msgpack_chunked_array__ leaves (arrays above "
                             "1 GiB, split by flax) are not supported")
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code == 1:
            return _ndarray(payload)
        if code == 3:
            return _ndarray(payload)[()]
        if code == 2:
            raise ValueError("msgpack ext 2 (a Python complex) is not "
                             "supported")
        raise ValueError(f"unknown msgpack ext type {code}")


def _ndarray(payload) -> np.ndarray:
    """flax's ndarray payload: msgpack (shape, dtype name, bytes)."""
    shape, name, buffer = _Reader(payload).value()
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """The tree flax.serialization.msgpack_restore reads from `data`."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack tree")
    return tree


def _header(out: bytearray, n: int, small: int, small_limit: int,
            codes: tuple) -> None:
    """A length header: `small | n` below `small_limit`, else the first of
    `codes` (8-, 16-, 32-bit length; None where msgpack has no such form)
    whose length field holds n."""
    if n < small_limit:
        out.append(small | n)
        return
    for code, fmt in zip(codes, (">B", ">H", ">I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
        if v > 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        bits = 8 * struct.calcsize(fmt)
        if (v < 1 << bits) if v > 0 else (v >= -(1 << (bits - 1))):
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixed:
        out.append(fixed[len(payload)])
    else:
        _header(out, len(payload), 0, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's (shape, dtype name, C-order bytes), packed as msgpack."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured arrays have no flax "
                         "msgpack form")
    out = bytearray()
    _pack([[int(d) for d in arr.shape], arr.dtype.name, arr.tobytes("C")],
          out)
    return bytes(out)


def _pack(value: Any, out: bytearray) -> None:
    # Exact types, as flax packs with msgpack's strict_types: a subclass
    # (np.float64 of float, np.bool_) goes through flax's ext types.
    kind = type(value)
    if value is None:
        out.append(0xC0)
    elif kind is bool:
        out.append(0xC3 if value else 0xC2)
    elif kind is int:
        _pack_int(out, value)
    elif kind is float:
        out.append(0xCB)
        out += struct.pack(">d", value)
    elif kind is str:
        data = value.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif kind is bytes:
        _header(out, len(value), 0, 0, (0xC4, 0xC5, 0xC6))
        out += value
    elif kind is list:
        _header(out, len(value), 0x90, 16, (None, 0xDC, 0xDD))
        for item in value:
            _pack(item, out)
    elif kind is dict:
        # Keys sorted: flax copies the tree with jax.tree_util first, which
        # sorts every dict's keys.
        _header(out, len(value), 0x80, 16, (None, 0xDE, 0xDF))
        for key in sorted(value):
            _pack(key, out)
            _pack(value[key], out)
    elif isinstance(value, np.ndarray):
        if value.nbytes > _MAX_LEAF_BYTES:
            raise ValueError("array leaves above 1 GiB (which flax splits "
                             "into __msgpack_chunked_array__ pieces) are not "
                             "supported")
        _pack_ext(out, 1, _ndarray_payload(value))
    elif isinstance(value, np.generic):
        _pack_ext(out, 3, _ndarray_payload(np.asarray(value)))
    else:
        raise TypeError(f"{kind.__name__} has no flax msgpack form")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes flax.serialization.msgpack_serialize writes for `tree`."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


def checkpoint_file(path: str) -> str:
    """`path` itself, or in a directory its newest checkpoint_N file (as
    flax.training.checkpoints.restore_checkpoint picks it)."""
    if not os.path.isdir(path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"no flax checkpoint at {path}")
        return path
    steps = [(int(m.group(1)), name) for name in os.listdir(path)
             if (m := _CHECKPOINT_RE.match(name))]
    if not steps:
        raise FileNotFoundError(f"no flax checkpoint at {path}")
    return os.path.join(path, max(steps)[1])


def extract_reference_params(path: str) -> Tuple[dict, int]:
    """A reference Mip-NeRF 360 TrainState checkpoint ({'params': {'params':
    {...}}, 'step': n, 'opt_state': ...}, train_utils.py:512) -> (the
    variables, always under a top 'params' key, and the step)."""
    with open(checkpoint_file(path), "rb") as f:
        raw = msgpack_restore(f.read())
    step = int(raw.get("step", 0))
    params = raw["params"]
    if "params" not in params:
        params = {"params": params}
    return params, step
