"""The JAX package's checkpoint format, read and written without flax,
the ``msgpack`` package or jax.

The JAX package saves a checkpoint as ``flax.serialization.msgpack_
serialize`` of ``{"params", "opt_state", "step", "extra"}``
(``vlbert_tpu/training/checkpoint.py``). That is plain msgpack with three
extension types, defined in flax's ``serialization.py``:

* code 1, an ndarray: the msgpack array ``[shape, dtype name, bytes]``
  (row major);
* code 2, a Python complex: the msgpack array ``[real, imag]``;
* code 3, a numpy scalar: a 0-d ndarray as in code 1;

and arrays of more than ``MAX_CHUNK_SIZE`` bytes that are the values of a
map (or the whole tree) are split into ``{"__msgpack_chunked_array__":
True, "shape": {"0": d0, ...}, "chunks": {"0": a0, ...}}`` maps of 1-D
chunks.

``loads`` / ``load`` decode the whole of msgpack (nil, bool, every int
and float width, str and bin 8/16/32, fixarray / array16 / array32, fixmap
/ map16 / map32, fixext / ext 8/16/32) into dicts, lists, str, bytes,
numbers and CPU tensors. Every ndarray becomes a tensor of its dtype, bit
for bit: ``bfloat16``, which numpy lacks, is read as raw bytes and viewed
as ``torch.bfloat16``. A numpy scalar (code 3) becomes a 0-d tensor, where
flax's ``msgpack_restore`` gives a numpy scalar; chunked arrays are joined
as ``msgpack_restore`` joins them.

``dumps`` / ``dump`` are the inverse: a tree of dicts with str keys,
lists, None, bool, int, float, str, bytes, complex, numpy arrays and
scalars and tensors becomes the bytes ``msgpack_serialize`` gives for the
same tree (a tensor as the numpy array of its dtype; every map with its
keys sorted, as jax's tree_map leaves them). The port saves its
own torch format; the writer makes a JAX-layout file where there is no
JAX (``chip_smoke.py``, the tests).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in chunks
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# numpy dtype names (flax writes ``arr.dtype.name``) -> torch dtypes
DTYPES = {name: getattr(torch, name) for name in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "bfloat16", "float32", "float64", "complex64",
    "complex128") if hasattr(torch, name)}
NAMES = {dt: name for name, dt in DTYPES.items()}


# ------------------------------------------------------------------ reader

class _Reader:
    """One pass over a msgpack buffer; ``pos`` is the next byte."""

    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = 0

    def take(self, n):
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {start} "
                             f"(wants {n} of {len(self.buf) - start})")
        return start

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, self.buf, self.take(size))[0]

    def bytes_(self, n):
        start = self.take(n)
        return bytes(self.view[start:start + n])

    def header(self):
        """(kind, n) of the next object: for map, array, str, bin and ext
        the length ``n`` (fix forms carry it in the type byte, the others
        in the 1, 2 or 4 bytes after it), for nil, bool, int and float the
        value."""
        b = self.buf[self.take(1)]
        if b <= 0x7f:
            return "value", b
        if b >= 0xe0:
            return "value", b - 0x100
        for lo, hi, kind in _FIX:
            if lo <= b <= hi:
                return kind, b - lo
        if b in _WIDE:
            kind, fmt = _WIDE[b]
            return kind, self.unpack(fmt)
        if b in _FIXEXT:
            return "ext", _FIXEXT[b]
        if b in _SCALARS:
            return "value", self.unpack(_SCALARS[b])
        if b in (0xc0, 0xc2, 0xc3):
            return "value", {0xc0: None, 0xc2: False, 0xc3: True}[b]
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} "
                         f"starts no object")

    def decode(self):
        kind, n = self.header()
        if kind == "map":
            out = {}
            for _ in range(n):
                key = self.decode()
                out[key] = self.decode()
            return out
        if kind == "array":
            return [self.decode() for _ in range(n)]
        if kind == "str":
            return self.bytes_(n).decode("utf-8")
        if kind == "bin":
            return self.bytes_(n)
        if kind == "ext":
            return self.ext(self.unpack(">b"), n)
        return n

    def ext(self, code, n):
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            out = self.ndarray()
        elif code == EXT_COMPLEX:
            real, imag = self.decode()
            out = complex(real, imag)
        else:
            raise ValueError(f"msgpack: extension type {code} is not "
                             f"one of flax's (1, 2, 3)")
        if self.pos != end:
            raise ValueError(f"msgpack: extension {code} is {n} bytes, "
                             f"its content {self.pos - end + n}")
        return out

    def ndarray(self):
        """flax's ``_ndarray_to_bytes``: [shape, dtype name, data] with the
        data read in place and copied once into the tensor."""
        if self.header() != ("array", 3):
            raise ValueError("msgpack: an ndarray is [shape, dtype, data]")
        shape = [int(d) for d in self.decode()]
        name = self.decode()
        name = name.decode() if isinstance(name, bytes) else name
        if name not in DTYPES:
            raise ValueError(f"msgpack: ndarray dtype {name!r} has no "
                             f"torch dtype")
        kind, n = self.header()
        if kind not in ("bin", "str"):
            raise ValueError("msgpack: ndarray data is not bin")
        start = self.take(n)
        dtype = DTYPES[name]
        numel = int(np.prod(shape, dtype=np.int64))
        if n != numel * dtype.itemsize:
            raise ValueError(f"msgpack: ndarray {name}{shape} holds {n} "
                             f"bytes")
        if n == 0:
            return torch.empty(shape, dtype=dtype)
        # a copy: the view into the file's buffer need not be aligned
        raw = np.frombuffer(self.buf, np.uint8, n, start).copy()
        return torch.from_numpy(raw).view(dtype).reshape(shape)


# (first, last type byte, kind) of the fix forms
_FIX = ((0x80, 0x8f, "map"), (0x90, 0x9f, "array"), (0xa0, 0xbf, "str"))
# type byte -> (kind, struct format of the length after it)
_WIDE = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
         0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
         0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
         0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
         0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
# type byte -> struct format of the int or float after it
_SCALARS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
            0xca: ">f", 0xcb: ">d"}


def _unchunk(d):
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps at the top
    or as the values of maps (not inside lists) become one tensor."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if CHUNKED in v else _unchunk_tree(v)
    return d


def loads(buf):
    """msgpack bytes (flax's format) -> the tree ``msgpack_restore``
    gives, with every array a CPU tensor."""
    reader = _Reader(buf)
    tree = reader.decode()
    if reader.pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - reader.pos} bytes after "
                         f"the object")
    return _unchunk_tree(tree)


def load(path):
    """``loads`` of a file, read once into one buffer."""
    with open(path, "rb") as f:
        buf = bytearray(f.seek(0, 2))
        f.seek(0)
        f.readinto(buf)
    return loads(buf)


# ------------------------------------------------------------------ writer

def _head(out, n, fix_base, fix_max, wide):
    """A length header: the fix form below ``fix_max``, else the first of
    ``wide`` [(type byte, struct format, limit)] that holds ``n``."""
    if fix_base is not None and n < fix_max:
        out.append(bytes([fix_base | n]))
        return
    for byte, fmt, limit in wide:
        if n < limit:
            out.append(bytes([byte]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} is too large")


_W8, _W16, _W32 = 1 << 8, 1 << 16, 1 << 32


def _int(out, v):
    """msgpack-python's choice: the smallest unsigned form for v > 0, the
    smallest signed form otherwise (fixints in one byte)."""
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v > 0:
        for byte, fmt, limit in ((0xcc, ">B", _W8), (0xcd, ">H", _W16),
                                 (0xce, ">I", _W32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                out.append(bytes([byte]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"msgpack: int {v} is too large")
    else:
        for byte, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if v >= low:
                out.append(bytes([byte]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"msgpack: int {v} is too small")


def _bin(out, data):
    _head(out, len(data), None, 0, ((0xc4, ">B", _W8), (0xc5, ">H", _W16),
                                    (0xc6, ">I", _W32)))
    out.append(data)


def _str(out, s):
    data = s.encode("utf-8")
    _head(out, len(data), 0xa0, 32, ((0xd9, ">B", _W8), (0xda, ">H", _W16),
                                     (0xdb, ">I", _W32)))
    out.append(data)


def _ext(out, code, parts):
    n = sum(len(p) for p in parts)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fix:
        out.append(bytes([fix[n]]))
    else:
        _head(out, n, None, 0, ((0xc7, ">B", _W8), (0xc8, ">H", _W16),
                                (0xc9, ">I", _W32)))
    out.append(struct.pack(">b", code))
    out.extend(parts)


def _array_parts(arr):
    """flax's ``_ndarray_to_bytes`` of a numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype not in NAMES:
            raise TypeError(f"msgpack: tensor dtype {t.dtype} has no numpy "
                            f"name")
        shape, name = tuple(t.shape), NAMES[t.dtype]
        data = t.reshape(-1).view(torch.uint8).numpy().data if t.numel() \
            else b""
    else:
        a = np.asarray(arr)
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    inner = [b"\x93"]
    _head(inner, len(shape), 0x90, 16, ((0xdc, ">H", _W16),
                                        (0xdd, ">I", _W32)))
    for d in shape:
        _int(inner, int(d))
    _str(inner, name)
    _bin(inner, data)
    return inner


def _nbytes(arr):
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk(arr):
    """flax's ``_chunk``: 1-D chunks of MAX_CHUNK_SIZE bytes at most."""
    if isinstance(arr, torch.Tensor):
        flat, itemsize = arr.detach().reshape(-1), arr.element_size()
    else:
        flat, itemsize = arr.reshape(-1), arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return _Written({CHUNKED: True,
                     "shape": _Written((str(i), d)
                                       for i, d in enumerate(arr.shape)),
                     "chunks": _Written((str(i), c)
                                        for i, c in enumerate(chunks))})


class _Written(dict):
    """A map flax builds after its tree_map (a chunked array's): written
    in its own order, where the tree's maps are written sorted."""


def _pack(out, obj, chunk=False):
    """``chunk``: ``obj`` is the root or reached from it through maps
    alone, where flax's ``_chunk_array_leaves_in_place`` splits large
    arrays (it does not look inside lists)."""
    if chunk and isinstance(obj, (torch.Tensor, np.ndarray)) \
            and _nbytes(obj) > MAX_CHUNK_SIZE:
        obj = _chunk(obj)
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _ext(out, EXT_NDARRAY, _array_parts(obj))
    elif isinstance(obj, np.generic):
        _ext(out, EXT_NPSCALAR, _array_parts(np.asarray(obj)))
    elif type(obj) is int:
        _int(out, obj)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is complex:
        _ext(out, EXT_COMPLEX, [b"\x92\xcb" + struct.pack(">d", obj.real)
                                + b"\xcb" + struct.pack(">d", obj.imag)])
    elif type(obj) is str:
        _str(out, obj)
    elif type(obj) in (bytes, bytearray, memoryview):
        _bin(out, bytes(obj))
    elif type(obj) is list:
        _head(out, len(obj), 0x90, 16, ((0xdc, ">H", _W16),
                                        (0xdd, ">I", _W32)))
        for v in obj:
            _pack(out, v)
    elif type(obj) in (dict, _Written):
        _head(out, len(obj), 0x80, 16, ((0xde, ">H", _W16),
                                        (0xdf, ">I", _W32)))
        # msgpack_serialize copies the tree with jax.tree_util.tree_map,
        # which sorts every map's keys
        keys = obj if type(obj) is _Written else sorted(obj)
        for k in keys:
            _pack(out, k)
            _pack(out, obj[k], chunk)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def dumps(tree):
    """The bytes of ``flax.serialization.msgpack_serialize(tree)``."""
    out = []
    _pack(out, tree, chunk=True)
    return b"".join(out)


def dump(tree, path):
    """``dumps`` to ``path`` (through a temporary file and a rename)."""
    import os

    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(dumps(tree))
    os.replace(tmp, path)
