"""Flax variable tree -> the port's state_dict.

The inverse of the JAX package's torch -> Flax converter
(``raft_tpu/checkpoint/convert.py``), so one set of weights loads into both
packages:

  * ``kernel`` (HWIO) -> ``weight`` (OIHW),
  * ``scale`` (norm affine) -> ``weight``,
  * ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``,
    with ``num_batches_tracked`` = 0 as torchvision's BatchNorm carries it,
  * Flax ``layers_N`` module names -> Sequential indices ``N``
    (``convcorr1/layers_0`` -> ``convcorr1.0``).

The result is also the torchvision RAFT key layout, so it loads with
``load_state_dict(strict=True)``.

:func:`load_msgpack` reads the JAX package's weight files (Flax
``serialization.to_bytes`` of a variable tree, what its ``load_variables``
reads) into the nested dict of numpy arrays that
:func:`state_dict_from_flax` takes, with a decoder of its own: neither
``msgpack`` nor ``flax`` is needed.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["load_msgpack", "state_dict_from_flax", "unpack_msgpack"]

_FLAX_NDARRAY_EXT = 1  # flax.serialization: ext payload = packb((shape, dtype name, raw bytes))


class _Reader:
    """Decoder of the msgpack subset a Flax weight file uses: nil, bool,
    ints, floats, str, bin, arrays, maps and ext (code 1 = ndarray)."""

    _FIXED = {  # first byte -> (struct format, value kind)
        0xCA: (">f", "num"), 0xCB: (">d", "num"),
        0xCC: (">B", "num"), 0xCD: (">H", "num"), 0xCE: (">I", "num"), 0xCF: (">Q", "num"),
        0xD0: (">b", "num"), 0xD1: (">h", "num"), 0xD2: (">i", "num"), 0xD3: (">q", "num"),
        0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map"),
        0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    }
    _FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more)")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        if tag in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[tag]
        if tag in self._FIXEXT:
            return self.ext(self._FIXEXT[tag])
        if tag not in self._FIXED:
            raise ValueError(f"msgpack: unknown type byte 0x{tag:02x} at byte {self.pos - 1}")
        fmt, kind = self._FIXED[tag]
        n = self.unpack(fmt)
        if kind == "num":
            return n
        if kind == "str":
            return self.str(n)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != _FLAX_NDARRAY_EXT:
            raise ValueError(f"msgpack: ext type {code} is not supported (only Flax ndarrays, type 1)")
        shape, dtype, raw = unpack_msgpack(payload)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpack_msgpack(data: bytes):
    """Decode one msgpack document; raises on trailing bytes."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} trailing bytes")
    return out


def load_msgpack(path: str) -> Dict[str, Any]:
    """A Flax ``.msgpack`` weight file -> nested dict of numpy arrays
    (``{'params': ...[, 'batch_stats': ...]}``)."""
    with open(path, "rb") as f:
        tree = unpack_msgpack(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: expected a map at the top level, got {type(tree).__name__}")
    return tree


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_path(scope: Tuple[str, ...]) -> str:
    return ".".join(p[len("layers_"):] if p.startswith("layers_") else p for p in scope)


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert ``{'params': ...[, 'batch_stats': ...]}`` (numpy-convertible
    leaves) to a flat state_dict of fp32 tensors."""
    state: Dict[str, torch.Tensor] = {}

    def put(key: str, arr) -> None:
        if key in state:
            raise ValueError(f"duplicate state_dict key {key!r}")
        state[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))

    for (*scope, leaf), value in _leaves(variables.get("params", {})):
        arr = np.asarray(value)
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(scope)}: expected a 4-D HWIO kernel, got {arr.shape}")
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            leaf = "weight"
        put(f"{_module_path(tuple(scope))}.{leaf}", arr)
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for (*scope, leaf), value in _leaves(variables.get("batch_stats", {})):
        if leaf not in stats_names:
            raise ValueError(f"unknown batch statistic {'/'.join(scope + [leaf])}")
        module = _module_path(tuple(scope))
        put(f"{module}.{stats_names[leaf]}", np.asarray(value))
        if leaf == "mean":
            state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state
