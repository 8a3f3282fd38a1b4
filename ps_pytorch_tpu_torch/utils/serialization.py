"""The checkpoint wire format: the role ``flax.serialization`` and
``msgpack`` play for the JAX package, written for the port's state types
with numpy and the standard library (the card's machine has neither flax
nor msgpack).

- ``to_state_dict`` / ``from_state_dict``: the port's state (dataclasses
  such as ``PSTrainState``, ``SGDState`` and ``GuardState``, ``FlatVector``,
  nested dicts and lists, tensors) to and from flax's state dict: a
  dataclass is a dict of its fields in declaration order, a list is
  ``{'0': ...}``, a type registered with ``register_serialization_state``
  is what its handler makes of it (``parallel/buckets.py`` registers
  ``FlatVector``, which is stored as its TREE, as the JAX package's
  buckets.py:364-404 handlers store it), and every plain dict has its keys
  sorted, as they come out of ``jax.device_get`` on the JAX side. Tensors
  come to the host as numpy arrays (copies, so a later in-place update of
  the live state cannot reach them); bf16 tensors stay CPU torch tensors,
  numpy has no bf16.
- ``packb`` / ``unpackb``: the msgpack subset flax emits
  (``msgpack_serialize``: ``strict_types=True``, ``use_bin_type=True``):
  maps, str, bool, None, ints in msgpack's smallest form, Python floats as
  float64, arrays as ext type 1 (the msgpack of ``(shape, dtype name, raw
  C-order bytes)``, ``bfloat16`` by name) and numpy scalars as ext type 3.
  ``unpackb`` reads every msgpack type and flax's
  ``__msgpack_chunked_array__`` form (arrays above 2**30 bytes). The bytes
  are flax's own: ``packb(to_state_dict(state))`` equals
  ``flax.serialization.to_bytes`` of the JAX package's state holding the
  same values.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's: arrays above it are written chunked

# ----------------------------------------------------------- state dicts

_STATE_HANDLERS: Dict[type, Tuple[Callable, Callable]] = {}


def register_serialization_state(ty: type, ty_to_state: Callable,
                                 ty_from_state: Callable) -> None:
    """flax's registry, for a type this module does not know:
    ``ty_to_state(x)`` gives a structure that ``to_state_dict`` then
    converts, and ``ty_from_state(target, state, path)`` restores a state
    dict into ``target`` (``from_state_dict`` is its recursion)."""
    _STATE_HANDLERS[ty] = (ty_to_state, ty_from_state)


def host_array(t: torch.Tensor):
    """A tensor's host copy: a numpy array, or a contiguous CPU bf16 tensor."""
    t = t.detach().to("cpu", copy=True).contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def to_state_dict(x) -> Any:
    """flax's state dict of ``x`` with host leaves (see the module text)."""
    handler = _STATE_HANDLERS.get(type(x))
    if handler is not None:
        return to_state_dict(handler[0](x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_state_dict(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): to_state_dict(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(x)}
    if isinstance(x, torch.Tensor):
        return host_array(x)
    if isinstance(x, np.generic):
        # jax.device_get turns a numpy scalar into a 0-d array
        return np.asarray(x)
    return x


def _leaf(target: torch.Tensor, state, path: str) -> torch.Tensor:
    if isinstance(state, torch.Tensor):
        t = state
    else:
        arr = np.asarray(state)
        if arr.dtype == object:
            raise ValueError(f"checkpoint leaf at {path or '.'} is not an array: {state!r}")
        t = torch.tensor(arr)
    if tuple(t.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint leaf at {path or '.'} has shape {tuple(t.shape)}, "
                         f"the target {tuple(target.shape)}")
    return t.to(device=target.device, dtype=target.dtype)


def from_state_dict(target, state, path: str = ""):
    """Restore ``state`` (a state dict, e.g. read back by ``unpackb``)
    into the structure of ``target``: the same types, dtypes and devices,
    shapes checked. A missing or unexpected key raises ValueError, as
    flax's restore does."""
    where = path or "."
    handler = _STATE_HANDLERS.get(type(target))
    if handler is not None:
        return handler[1](target, state, path)
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        names = [f.name for f in dataclasses.fields(target)]
        _same_keys(names, state, where)
        return dataclasses.replace(target, **{
            n: from_state_dict(getattr(target, n), state[n], f"{path}/{n}") for n in names})
    if isinstance(target, dict):
        _same_keys([str(k) for k in target], state, where)
        return {k: from_state_dict(v, state[str(k)], f"{path}/{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        _same_keys([str(i) for i in range(len(target))], state, where)
        return type(target)(from_state_dict(v, state[str(i)], f"{path}/{i}")
                            for i, v in enumerate(target))
    if isinstance(target, torch.Tensor):
        return _leaf(target, state, path)
    if target is None:
        if state is not None:
            raise ValueError(f"checkpoint carries state at {where} where the target has "
                             f"none (None)")
        return None
    if isinstance(target, int):
        return int(np.asarray(state))
    return state


def _same_keys(names: List[str], state, where: str) -> None:
    if not isinstance(state, dict):
        raise ValueError(f"checkpoint holds {type(state).__name__} at {where}, the target "
                         f"a structure with keys {names}")
    missing, extra = set(names) - set(state), set(state) - set(names)
    if missing or extra:
        raise ValueError(f"checkpoint keys at {where} do not match the target: missing "
                         f"{sorted(missing)}, unexpected {sorted(extra)}")


# --------------------------------------------------------------- msgpack


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0 <= v <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", v))
    elif -0x80 <= v < 0:
        out.append(b"\xd0" + struct.pack("b", v))
    elif 0 <= v <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", v))
    elif -0x8000 <= v < 0:
        out.append(b"\xd1" + struct.pack(">h", v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", v))
    elif -0x80000000 <= v < 0:
        out.append(b"\xd2" + struct.pack(">i", v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", v))
    elif -0x8000000000000000 <= v < 0:
        out.append(b"\xd3" + struct.pack(">q", v))
    else:
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _header(out: List[bytes], n: int, fix: int, fix_max: int, codes: bytes) -> None:
    """A length header: the fix form up to ``fix_max``, then the 8- (if
    ``codes`` has three), 16- and 32-bit forms."""
    if n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    forms = [(0xFF, "B"), (0xFFFF, ">H"), (0xFFFFFFFF, ">I")][3 - len(codes):]
    for code, (top, fmt) in zip(codes, forms):
        if n <= top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack's 32 bits")


def _str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _header(out, len(b), 0xA0, 31, b"\xd9\xda\xdb")
    out.append(b)


def _bin(out: List[bytes], b) -> None:
    n = len(b)
    _header(out, n, 0, -1, b"\xc4\xc5\xc6")
    out.append(b)


def _ext(out: List[bytes], code: int, parts: List[bytes]) -> None:
    n = sum(len(p) for p in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n <= 0xFF:
        out.append(b"\xc7" + struct.pack("B", n) + bytes([code]))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">H", n) + bytes([code]))
    else:
        out.append(b"\xc9" + struct.pack(">I", n) + bytes([code]))
    out.extend(parts)


def _array_parts(shape, dtype_name: str, raw) -> List[bytes]:
    """flax's ``_ndarray_to_bytes``: the msgpack of (shape, dtype, bytes)."""
    parts: List[bytes] = []
    _header(parts, 3, 0x90, 15, b"\xdc\xdd")
    _header(parts, len(shape), 0x90, 15, b"\xdc\xdd")
    for d in shape:
        _int(parts, int(d))
    _str(parts, dtype_name)
    _bin(parts, raw)
    return parts


def _array_raw(x):
    """(shape, dtype name, C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    if x.dtype.hasobject:
        raise ValueError("object arrays cannot be serialized")
    return x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()


def _chunk(arr):
    """flax's ``_chunk``: an array above MAX_CHUNK_SIZE bytes as a dict of
    flat pieces."""
    if isinstance(arr, torch.Tensor):
        flat = arr.reshape(-1)
        item = arr.element_size()
    else:
        flat = arr.reshape(-1)
        item = arr.dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // item)
    return {CHUNKED_KEY: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size]
                       for i, j in enumerate(range(0, flat.shape[0], size))}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _pack(out: List[bytes], x) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _str(out, x)
    elif type(x) is bytes:
        _bin(out, x)
    elif type(x) is dict:
        _header(out, len(x), 0x80, 15, b"\xde\xdf")
        for k, v in x.items():
            _pack(out, k)
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pack(out, v)
    elif type(x) in (list, tuple):
        _header(out, len(x), 0x90, 15, b"\xdc\xdd")
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext(out, EXT_NDARRAY, _array_parts(*_array_raw(x)))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _array_parts(*_array_raw(np.asarray(x))))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(x) -> bytes:
    """msgpack bytes of a state dict, as flax's ``msgpack_serialize``
    writes them (a top-level array leaf above the chunk size is chunked,
    as a dict's is)."""
    if isinstance(x, (np.ndarray, torch.Tensor)) and _nbytes(x) > MAX_CHUNK_SIZE:
        x = _chunk(x)
    out: List[bytes] = []
    _pack(out, x)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.i = 0

    def take(self, n: int) -> memoryview:
        j = self.i + n
        if j > len(self.buf):
            raise ValueError("msgpack data ends early (truncated)")
        out = self.buf[self.i:j]
        self.i = j
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.list(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in sizes:
            raise ValueError(f"byte 0x{b:02x} is not a msgpack type")
        n = self.unpack(sizes[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        return self.list(n) if b <= 0xDD else self.map(n)

    def list(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        body = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one flax writes")
        inner = _Reader(body)
        head = inner.unpack("B")
        if head != 0x93:
            raise ValueError("an array ext does not hold (shape, dtype, bytes)")
        shape = tuple(inner.read())
        name = inner.read()
        raw = inner.read()
        if isinstance(name, bytes):
            name = name.decode()
        if name == "bfloat16":
            arr = torch.frombuffer(bytearray(raw), dtype=torch.int16).view(torch.bfloat16)
            return arr.reshape(shape)
        arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(x):
    if isinstance(x, dict):
        if CHUNKED_KEY in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def unpackb(data) -> Any:
    """The state dict of msgpack bytes (flax's ``msgpack_restore``):
    arrays as read-only numpy arrays (bf16 as torch tensors), chunked
    arrays joined. Damaged bytes raise ValueError."""
    r = _Reader(data)
    try:
        out = r.read()
    except (struct.error, UnicodeDecodeError, TypeError, IndexError) as e:
        raise ValueError(f"cannot decode msgpack: {e}") from e
    if r.i != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.i} bytes follow the msgpack object")
    return _unchunk(out)
