"""The subset of msgpack that flax's `serialization.to_bytes` writes, in pure Python.

The JAX package stores its checkpoint directories' `params.msgpack` with
`flax.serialization`; the port reads them without msgpack or flax. Types: nil,
bool, ints and floats of every width, str, bin, array and map (fix, 8, 16 and
32 forms), and ext (fixext, 8, 16, 32) with flax's codes: 1, an ndarray, whose
payload is itself a packed (shape, dtype name, raw bytes); 2, a Python
complex; 3, a numpy scalar (a 0-d ndarray payload).

`unpackb` returns what flax's `msgpack_restore` returns: maps as dicts (lists
and tuples were written as string-indexed dicts), arrays as numpy arrays
sliced out of the buffer with `np.frombuffer` (no copy), chunked leaves
(`{"__msgpack_chunked_array__": True, "shape", "chunks"}`) reassembled. A
`bfloat16` array comes back as a torch.bfloat16 tensor, the uint16 bits viewed
as they are. `pack_to` / `packb` write the same bytes as
`flax.serialization.to_bytes` for the same tree (insertion order kept; lists
and tuples as string-indexed dicts; arrays of more than MAX_CHUNK_SIZE bytes
chunked); a torch tensor leaf is written as the ndarray it holds (bf16 as
`bfloat16`).
"""

import struct
from typing import Any, BinaryIO, List

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# flax's limit on one array leaf's bytes before it is written in chunks
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------------------- read


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.mv):
            raise ValueError("msgpack: truncated data")
        return self.mv[start:self.pos]

    def unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.mv, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def obj(self) -> Any:
        b = self.mv[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), self.take(n))
        if b in (0xCA, 0xCB):
            return self.unpack(">f" if b == 0xCA else ">d")
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.unpack(">" + "BHI"[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, data: memoryview):
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).obj()
            return complex(real, imag)
        raise ValueError(f"msgpack: unsupported ext code {code}")


def _ndarray(data: memoryview):
    """flax's ndarray payload (shape, dtype name, raw bytes) -> a numpy array over
    `data` (a torch.bfloat16 tensor for `bfloat16`)."""
    r = _Reader(data)
    b = r.mv[r.pos]
    if not 0x90 <= b <= 0x9F or (b & 0x0F) != 3:
        raise ValueError("msgpack: an ndarray payload is a 3-array")
    r.pos += 1
    shape = tuple(r.obj())
    name = r.obj()
    name = name.decode() if isinstance(name, (bytes, bytearray)) else name
    b = r.mv[r.pos]
    r.pos += 1
    if b not in (0xC4, 0xC5, 0xC6):
        raise ValueError("msgpack: an ndarray's data is bin")
    raw = r.take(r.unpack(">" + "BHI"[b - 0xC4]))
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16) if bits.flags.writeable else \
            torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(buf) -> Any:
    """`buf` (bytes, bytearray or any buffer) -> the tree, as msgpack_restore
    returns it. Arrays are views of `buf` (writable where `buf` is)."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.mv):
        raise ValueError(f"msgpack: {len(r.mv) - r.pos} bytes after the object")
    return _unchunk(out)


def load(path: str) -> Any:
    """The tree of the msgpack file at `path`, read into one writable buffer."""
    with open(path, "rb") as fd:
        fd.seek(0, 2)
        buf = bytearray(fd.tell())
        fd.seek(0)
        if fd.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return unpackb(buf)


# ----------------------------------------------------------------------------- write


def _int(v: int) -> bytes:
    if v < -(1 << 5):
        if v < -(1 << 15):
            return struct.pack(">Bi", 0xD2, v) if v >= -(1 << 31) else struct.pack(">Bq", 0xD3, v)
        return struct.pack(">Bh", 0xD1, v) if v < -(1 << 7) else struct.pack(">Bb", 0xD0, v)
    if v < (1 << 7):
        return struct.pack(">b", v) if v < 0 else bytes((v,))
    if v < (1 << 16):
        return struct.pack(">BB", 0xCC, v) if v < (1 << 8) else struct.pack(">BH", 0xCD, v)
    return struct.pack(">BI", 0xCE, v) if v < (1 << 32) else struct.pack(">BQ", 0xCF, v)


def _sized(n: int, fix: int, fix_max: int, codes, widths="BHI") -> bytes:
    """The header of a str / bin / array / map of n entries: the fix form where
    it has one (fix_max), else the smallest of the 8 (if any), 16, 32 forms."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, w in zip(codes, widths[-len(codes):]):
        if n < (1 << (8 * struct.calcsize(w))):
            return struct.pack(">B" + w, code, n)
    raise ValueError("msgpack: object too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext(code: int, payload: List[bytes]) -> List[bytes]:
    n = sum(len(p) for p in payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack(">Bb", fixed[n], code)
    elif n < (1 << 8):
        head = struct.pack(">BBb", 0xC7, n, code)
    elif n < (1 << 16):
        head = struct.pack(">BHb", 0xC8, n, code)
    else:
        head = struct.pack(">BIb", 0xC9, n, code)
    return [head] + payload


def _array_payload(arr) -> List[bytes]:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype name, bytes))."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else None
        arr = t.view(torch.uint16).numpy() if name else t.numpy()
    else:
        arr, name = (arr if arr.flags.c_contiguous else arr.copy(order="C")), None
    if arr.dtype.hasobject:
        raise ValueError("msgpack: object arrays are not supported")
    raw = memoryview(arr.reshape(-1).view(np.uint8)) if arr.size else b""
    head = [bytes((0x93,)), _sized(arr.ndim, 0x90, 15, (0xDC, 0xDD), "HI")]
    head += [_int(int(d)) for d in arr.shape]
    head += [_str(name or arr.dtype.name), _bin_header(len(raw))]
    return [b"".join(head), raw]


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def _chunk(arr) -> dict:
    """flax's `_chunk`: a flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _pieces(obj, out: List, top: bool = True) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out += [_bin_header(len(obj)), obj]
    elif isinstance(obj, (list, tuple)):
        _pieces({str(i): v for i, v in enumerate(obj)}, out, top)
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), 0x80, 15, (0xDE, 0xDF), "HI"))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack: a state dict has string keys, not {k!r}")
            out.append(_str(k))
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pieces(v, out, False)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        if top and _nbytes(obj) > MAX_CHUNK_SIZE:
            _pieces(_chunk(obj), out, False)
        else:
            out += _ext(EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        out += _ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif type(obj) is complex:
        out += _ext(EXT_COMPLEX, [bytes((0x92,)) + struct.pack(">Bd", 0xCB, obj.real)
                                  + struct.pack(">Bd", 0xCB, obj.imag)])
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(tree) -> bytes:
    """`tree` as the bytes `flax.serialization.to_bytes` writes for it."""
    out: List = []
    _pieces(tree, out)
    return b"".join(out)


def pack_to(fd: BinaryIO, tree) -> int:
    """`packb(tree)` written to `fd` piece by piece (no copy of the arrays'
    bytes into one buffer); -> the bytes written."""
    out: List = []
    _pieces(tree, out)
    n = 0
    for piece in out:
        fd.write(piece)
        n += len(piece)
    return n
