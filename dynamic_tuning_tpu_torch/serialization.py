"""The flax ``.msgpack`` file format, read and written without ``msgpack``,
``flax`` or ``ml_dtypes`` (counterpart of ``flax.serialization``'s
``msgpack_serialize`` / ``msgpack_restore``, which the JAX package's
checkpoints use).

The subset is flax's:

* maps (``str`` keys), arrays (Python lists), ``str``, ``bytes``, ``int``,
  ``float`` (written as doubles), ``None`` and ``bool``;
* ext 1 ``ndarray``: a packed ``[shape, dtype name, raw bytes]`` (row
  major), for numpy arrays and torch tensors;
* ext 2 ``native_complex``: a packed ``[real, imag]``;
* ext 3 ``npscalar``: a numpy scalar, encoded as a 0-d ``ndarray``;
* arrays above ``MAX_CHUNK_SIZE`` bytes as flax's chunked dict
  (``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}``).

``packb`` gives the bytes ``flax.serialization.msgpack_serialize`` gives
for the same tree: the smallest int encodings, the str/bin/map/array/ext
length boundaries, and every map's keys sorted (``msgpack_serialize``
copies the tree with ``jax.tree_util.tree_map``, which sorts dict keys).
As flax does, it refuses tuples.

``unpackb`` gives what ``msgpack_restore`` gives: numpy arrays (read-only
views of the buffer, no copy) and numpy scalars, except that ``bfloat16``,
which numpy lacks, comes back as a ``torch.bfloat16`` tensor (its bytes
read as ``uint16``).  Arrays are sliced out of one ``memoryview``, never
read element by element, so a ViT-B checkpoint decodes at the disk's rate.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

#: flax's limit on one array's bytes before it is chunked
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}


# --- writer ------------------------------------------------------------------

def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: the fix form
    (``fix | n`` for n <= ``fix_max``), else 8/16/32-bit lengths."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    c8, c16, c32 = codes
    if c8 is not None and n < 1 << 8:
        return bytes([c8, n])
    if n < 1 << 16:
        return struct.pack(">BH", c16, n)
    if n < 1 << 32:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack object of {n} items is too large")


def _int(x: int) -> bytes:
    if x >= 0:
        if x < 0x80:
            return bytes([x])
        for code, fmt, lim in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if x < lim:
                return struct.pack(fmt, code, x)
        raise OverflowError(f"int {x} does not fit msgpack's uint64")
    if x >= -32:
        return struct.pack(">b", x)
    for code, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                           (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
        if x >= -lim:
            return struct.pack(fmt, code, x)
    raise OverflowError(f"int {x} does not fit msgpack's int64")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _len_header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _len_header(n, None, -1, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _len_header(n, None, -1, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _array_parts(shape, name: str, data) -> List[Any]:
    """The pieces of ``packb([shape, name, data])`` (flax's
    ``_ndarray_to_bytes``), the data kept as a buffer, not copied."""
    head = bytes([0x93]) + _len_header(len(shape), 0x90, 15,
                                       (None, 0xDC, 0xDD))
    head += b"".join(_int(int(d)) for d in shape) + _str(name)
    n = memoryview(data).nbytes
    return [head + _bin_header(n), data]


def _tensor_bytes(t: torch.Tensor):
    """A torch tensor's dtype name and its row-major bytes (a buffer)."""
    if t.dtype not in _TORCH_NAMES:
        raise TypeError(f"can not serialize a {t.dtype} tensor")
    t = t.detach().cpu().contiguous()
    raw = t.reshape(-1).view(torch.uint8) if t.numel() else t.to(
        torch.uint8).reshape(-1)
    return _TORCH_NAMES[t.dtype], raw.numpy()


def _ext_array(code: int, shape, name: str, data, out: List[Any]) -> None:
    parts = _array_parts(shape, name, data)
    n = sum(memoryview(p).nbytes for p in parts)
    out.append(_ext_header(code, n))
    out.extend(parts)


class _Ordered(dict):
    """A dict written in insertion order: flax builds its chunked dicts
    after the tree's keys are sorted."""


def _chunk(shape, flat_numel: int, itemsize: int, slicer) -> dict:
    """flax's ``_chunk``: the flattened array in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    return _Ordered({
        _CHUNKED: True,
        "shape": _Ordered({str(i): int(d) for i, d in enumerate(shape)}),
        "chunks": _Ordered({str(j): slicer(i, i + size) for j, i in
                            enumerate(range(0, flat_numel, size))})})


def _encode(x, out: List[Any]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif type(x) is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        out.append(_str(x))
    elif type(x) is bytes:
        out.append(_bin_header(len(x)))
        out.append(x)
    elif type(x) in (dict, _Ordered):
        out.append(_len_header(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
        for k in (x if type(x) is _Ordered else sorted(x)):
            _encode(k, out)
            _encode(_maybe_chunk(x[k]), out)
    elif type(x) is list:
        out.append(_len_header(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in x:
            _encode(v, out)
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        _ext_array(_EXT_NDARRAY, x.shape, x.dtype.name,
                   np.ascontiguousarray(x).reshape(-1).view(np.uint8), out)
    elif isinstance(x, torch.Tensor):
        name, raw = _tensor_bytes(x)
        _ext_array(_EXT_NDARRAY, tuple(x.shape), name, raw, out)
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _ext_array(_EXT_NPSCALAR, (), a.dtype.name,
                   a.reshape(-1).view(np.uint8), out)
    elif type(x) is complex:
        payload = packb([x.real, x.imag])
        out.append(_ext_header(_EXT_COMPLEX, len(payload)))
        out.append(payload)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def _maybe_chunk(x):
    """An array above ``MAX_CHUNK_SIZE`` bytes as flax's chunked dict."""
    if isinstance(x, np.ndarray) and x.nbytes > MAX_CHUNK_SIZE:
        flat = x.reshape(-1)
        return _chunk(x.shape, flat.size, x.dtype.itemsize,
                      lambda i, j: flat[i:j])
    if isinstance(x, torch.Tensor) and (
            x.numel() * x.element_size() > MAX_CHUNK_SIZE):
        flat = x.detach().reshape(-1)
        return _chunk(tuple(x.shape), flat.numel(), x.element_size(),
                      lambda i, j: flat[i:j])
    return x


def pack_parts(tree) -> List[Any]:
    """``tree`` encoded as a list of byte pieces (array data as buffers,
    not copied): write them in order, or join them."""
    out: List[Any] = []
    _encode(_maybe_chunk(tree), out)
    return out


def packb(tree) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)``."""
    return b"".join(pack_parts(tree))


def write_file(path: str, tree) -> int:
    """Encode ``tree`` into ``path`` piece by piece; returns the bytes
    written."""
    n = 0
    with open(path, "wb") as f:
        for p in pack_parts(tree):
            n += f.write(p)
    return n


# --- reader ------------------------------------------------------------------

def _dtype(name: str):
    if name == "bfloat16":
        return None
    return np.dtype(name)


class _Reader:
    """msgpack decoding from one buffer; ``raw`` (an ndarray's inner
    ``[shape, name, bytes]``) keeps strings as bytes and the data as a
    view, as flax's ``unpackb(..., raw=True)``."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.buf[p:p + n]

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sized = {0xC4: (">B", 1, "bin"), 0xC5: (">H", 2, "bin"),
                 0xC6: (">I", 4, "bin"), 0xD9: (">B", 1, "str"),
                 0xDA: (">H", 2, "str"), 0xDB: (">I", 4, "str"),
                 0xDC: (">H", 2, "array"), 0xDD: (">I", 4, "array"),
                 0xDE: (">H", 2, "map"), 0xDF: (">I", 4, "map"),
                 0xC7: (">B", 1, "ext"), 0xC8: (">H", 2, "ext"),
                 0xC9: (">I", 4, "ext")}
        if c in sized:
            fmt, width, kind = sized[c]
            return getattr(self, kind)(self.unpack(fmt, width))
        numbers = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
                   0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
                   0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
                   0xD3: (">q", 8)}
        if c in numbers:
            return self.unpack(*numbers[c])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")

    def str(self, n: int):
        b = self.take(n)
        return bytes(b) if self.raw else str(b, "utf-8")

    def bin(self, n: int):
        # an ndarray's payload (raw mode) stays a view of the buffer
        return self.take(n) if self.raw else bytes(self.take(n))

    def array(self, n: int):
        return [self.read() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack map key {k!r} is not a string")
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from(data)
        if code == _EXT_NPSCALAR:
            a = _array_from(data)
            return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).read()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not flax's")


def _array_from(data: memoryview):
    """flax's ``_ndarray_from_bytes``: [shape, dtype name, bytes]."""
    shape, name, raw = _Reader(data, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    dt = _dtype(name)
    if dt is None:     # bfloat16: numpy has none; torch reads the bits
        bits = np.frombuffer(raw, np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).reshape(
            shape)
    return np.frombuffer(raw, dt).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def unpackb(data) -> Any:
    """The tree of ``flax.serialization.msgpack_restore(data)``."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return _unchunk_leaves(tree)


def read_file(path: str) -> Any:
    """Decode a ``.msgpack`` file (one read; arrays are views of it)."""
    with open(path, "rb") as f:
        return unpackb(f.read())
