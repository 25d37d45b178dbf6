"""Read flax's msgpack checkpoints without msgpack or flax
(≙ ``flax.serialization.msgpack_restore``, flax 0.12).

tts_tpu writes its checkpoints with ``flax.serialization.msgpack_serialize``
(``tts_tpu/train/checkpoint.py``): a msgpack map of nested maps whose leaves
are arrays, numpy scalars and plain values. This reader covers what that
writer emits:

- msgpack maps, arrays, str, bin, ints, floats, nil and bools;
- ext 1, an ndarray: the msgpack array (shape, dtype name, row-major
  bytes); ext 2, a complex number: the msgpack array (real, imag); ext 3, a
  numpy scalar, packed as a 0-d ndarray;
- flax's chunked arrays: a map with ``__msgpack_chunked_array__`` whose
  ``chunks`` ({"0": flat, "1": flat, ...}) are joined and reshaped to
  ``shape`` (flax splits leaves larger than its ``MAX_CHUNK_SIZE``).

Arrays come back as numpy arrays (writable copies), numpy scalars as numpy
scalars, except bfloat16, which numpy lacks: such a leaf is read as uint16
and returned as a ``torch.bfloat16`` tensor of the same bits. Anything else
raises ``ValueError`` with the byte offset.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, base: int = 0):
        self.data = memoryview(data)
        self.pos = 0
        self.base = base     # offset of data in the file, for messages

    def fail(self, what: str, at: int) -> None:
        raise ValueError(f"msgpack: {what} at byte {self.base + at}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted", self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack((">B", ">H", ">I")[b - 0xC4])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.ext(n, at)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack((">B", ">H", ">I", ">Q")[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack((">b", ">h", ">i", ">q")[b - 0xD0])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4), at)
        if b in (0xD9, 0xDA, 0xDB):
            return self.text(self.unpack((">B", ">H", ">I")[b - 0xD9]), at)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), at)
        self.fail(f"unknown type byte 0x{b:02x}", at)

    def text(self, n: int, at: int) -> str:
        try:
            return bytes(self.take(n)).decode("utf-8")
        except UnicodeDecodeError:
            self.fail("invalid UTF-8 string", at)

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if isinstance(key, (list, dict)):
                self.fail("unhashable map key", key_at)
            out[key] = self.value()
        return out

    def ext(self, n: int, at: int) -> Any:
        code = self.unpack(">b")
        body = self.pos
        payload = bytes(self.take(n))
        inner = _Reader(payload, self.base + body)
        if code == 1:
            return inner.ndarray()
        if code == 2:
            parts = inner.whole()
            if (not isinstance(parts, list) or len(parts) != 2
                    or not all(isinstance(v, (int, float)) for v in parts)):
                self.fail("malformed complex (ext 2)", at)
            return complex(parts[0], parts[1])
        if code == 3:
            arr = inner.ndarray()
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        self.fail(f"unsupported ext type {code}", at)

    def whole(self) -> Any:
        v = self.value()
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} trailing bytes",
                      self.pos)
        return v

    def ndarray(self):
        parts = self.whole()
        if (not isinstance(parts, list) or len(parts) != 3
                or not isinstance(parts[0], list)
                or not all(isinstance(s, int) and s >= 0 for s in parts[0])
                or not isinstance(parts[1], (str, bytes))
                or not isinstance(parts[2], bytes)):
            self.fail("malformed ndarray (ext 1)", 0)
        shape, name, buf = parts
        name = name.decode() if isinstance(name, bytes) else name
        bf16 = name == "bfloat16"
        try:
            dtype = np.dtype(np.uint16 if bf16 else name)
        except TypeError:
            self.fail(f"unknown dtype {name!r}", 0)
        if dtype.hasobject or len(buf) != dtype.itemsize * int(
                np.prod(shape, dtype=np.int64)):
            self.fail(f"ndarray of {len(buf)} bytes for {name} {shape}", 0)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr


def _unchunk(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        try:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            if chunks and isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        except (KeyError, TypeError, ValueError, RuntimeError) as e:
            raise ValueError(f"msgpack: malformed chunked array: {e}") from e
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree flax's ``msgpack_serialize`` wrote into ``data``."""
    return _unchunk(_Reader(bytes(data)).whole())
