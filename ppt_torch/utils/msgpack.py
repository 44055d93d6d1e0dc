"""The msgpack subset that flax's checkpoints use, read and written here.

Counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore`` (flax 0.12, ``serialization.py:249-415``) without the
``msgpack`` package, which the card's machine lacks:

- nil, bool, every int width, float32/64, str (fixstr, str8/16/32), bin
  (bin8/16/32), arrays (fixarray, array16/32), maps (fixmap, map16/32)
  and ext (fixext1/2/4/8/16, ext8/16/32);
- ext code 1 is an ndarray and ext code 3 a numpy scalar: both hold a
  packed ``(shape, dtype name, C-order bytes)``, decoded to a numpy array
  and a numpy scalar (so each writes back as it came). ``bfloat16`` has no
  numpy dtype without
  ``ml_dtypes``: it is read through a 16-bit integer view into a
  ``torch.bfloat16`` tensor, and such a tensor is written back the same way;
- arrays past ``MAX_CHUNK_SIZE`` bytes travel as flax's
  ``__msgpack_chunked_array__`` dicts, undone on reading;
- anything else raises ``ValueError`` by name: ext code 2 (a complex
  number), an unknown ext code, an unused type byte, a truncated buffer,
  bytes past the end of the object.

The writer packs as msgpack-python's ``Packer`` does under flax
(``strict_types=True``, ``use_bin_type=True``): the smallest int and
length encodings, fixext wherever the payload is 1, 2, 4, 8 or 16 bytes,
maps in the order given. ``msgpack_serialize`` sorts every dict's keys
first, as flax's ``jax.tree_util.tree_map`` copy of the tree does, so the
files it writes are flax's byte for byte.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax's: arrays of more bytes are chunked
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, n))
    elif -0x80 <= n < 0:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif 0xFF < n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < -0x80:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"msgpack: int {n} does not fit 64 bits")


def _pack_len(n: int, fix: Tuple[int, int], b8, b16: int, b32: int, out: List[bytes]) -> None:
    """A length header: the fix form (base byte, exclusive limit), else the
    8-bit form (when the type has one), else 16 or 32 bits."""
    base, limit = fix
    if n < limit:
        out.append(struct.pack("B", base | n))
    elif b8 is not None and n <= 0xFF:
        out.append(struct.pack(">BB", b8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", b16, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", b32, n))
    else:
        raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _pack_bin(data: bytes, out: List[bytes]) -> None:
    _pack_len(len(data), (0, 0), 0xC4, 0xC5, 0xC6, out)
    out.append(data)


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_parts(arr) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes("C")
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"msgpack: dtype {arr.dtype} is not a plain array type")
    return tuple(arr.shape), arr.dtype.name, arr.tobytes("C")


def _ndarray_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, name, data))`` with
    msgpack's default (non-strict) types, so the tuples are arrays."""
    shape, name, data = _array_parts(arr)
    out: List[bytes] = []
    _pack_len(3, (0x90, 16), None, 0xDC, 0xDD, out)
    _pack_len(len(shape), (0x90, 16), None, 0xDC, 0xDD, out)
    for d in shape:
        _pack_int(int(d), out)
    _pack_obj(name, out)
    _pack_bin(data, out)
    return b"".join(out)


def _pack_obj(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is bytes or t is bytearray:
        _pack_bin(bytes(obj), out)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), (0xA0, 32), 0xD9, 0xDA, 0xDB, out)
        out.append(data)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is list:
        _pack_len(len(obj), (0x90, 16), None, 0xDC, 0xDD, out)
        for item in obj:
            _pack_obj(item, out)
    elif t is dict:
        _pack_len(len(obj), (0x80, 16), None, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack_obj(k, out)
            _pack_obj(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"msgpack: cannot serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, default=<flax's ext packer>, strict_types=True)``:
    dicts in the order given."""
    out: List[bytes] = []
    _pack_obj(obj, out)
    return b"".join(out)


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk(arr) -> dict:
    """flax's ``_chunk``: the flat array in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes, keys as flax orders them."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _canonical(tree: Any) -> Any:
    """The tree as flax packs it: every dict's keys sorted (the
    ``tree_map`` copy), then arrays past ``MAX_CHUNK_SIZE`` bytes chunked."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            v = _canonical(tree[k])
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            out[k] = v
        return out
    if isinstance(tree, list):
        return [_canonical(v) for v in tree]
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    tree = _canonical(tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    return packb(tree)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated buffer: {n} bytes wanted at offset "
                             f"{self.pos}, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _LEN:
            kind, fmt = _LEN[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if b in _SCALAR:
            return self.unpack(_SCALAR[b])
        if b in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[b])
        raise ValueError(f"msgpack: type byte 0x{b:02x} at offset {self.pos - 1} is not used")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:  # a numpy scalar, as flax reads it (bf16: a 0-d tensor)
            arr = _ndarray_from_payload(data)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            raise ValueError("msgpack: ext code 2 (a complex number) is not read here")
        raise ValueError(f"msgpack: unknown ext code {code}")


_LEN = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
        0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
        0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
        0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_SCALAR = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
           0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _ndarray_from_payload(data: memoryview):
    """flax's ``_ndarray_from_bytes``: a writable copy, bfloat16 as a
    ``torch.bfloat16`` tensor."""
    r = _Reader(data)
    parts = r.obj()
    if r.pos != len(data) or not (isinstance(parts, list) and len(parts) == 3):
        raise ValueError("msgpack: an ndarray payload is not one (shape, dtype, bytes) triple")
    shape, name, raw = parts
    if not isinstance(raw, bytes) or not isinstance(name, str):
        raise ValueError("msgpack: an ndarray payload is not one (shape, dtype, bytes) triple")
    if name == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: an ndarray payload names the unknown dtype {name!r}") from None
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, ext_hook=<flax's ext unpacker>, raw=False)``,
    with the ext codes flax writes decoded to arrays."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes past the end of the object")
    return out


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: dicts only, in place."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            tree[k] = _unchunk_leaves(v)
    return tree


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree, chunked
    arrays joined."""
    return _unchunk_leaves(unpackb(data))
