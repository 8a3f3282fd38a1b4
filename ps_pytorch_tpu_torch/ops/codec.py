"""Host byte codec: the port's ``ctypes`` binding of ``native/codec.cc``
(the port of ops/codec.py), for compressed checkpoints (``PSCK`` files,
``--compress-checkpoints``) and the reference's four codec names.

The C++ source is the JAX package's own, compiled as it stands with the
host C++ compiler at first use, by ``data/_native.build`` (the same
compiler lookup, portable flags and hash-keyed path under
``ps_pytorch_tpu_torch/_build/``). It is host code, not a device kernel.

Blobs carry a one-byte tag: ``b"N"`` + the native stream (``PSC1``
header, 1 MiB blocks, each byte-shuffled by ``itemsize`` then LZ-coded
and checksummed; the blocks do not depend on ``n_threads``), so
``compress_bytes`` writes the JAX package's bytes exactly. Reading also
takes ``b"Z"`` + zlib, which the JAX package writes when it has no
compiler.

Declared deviation: nothing falls back to zlib on write. When the
library cannot be built or loaded, compressing (and reading an ``N``
blob) raises ``data._native.NativeBuildError``.

Arrays are framed as ``b"PSAR"`` + a little-endian u32 header length +
a JSON ``{"dtype", "shape"}`` header + the compressed bytes
(``compress_array``; the reference's ``blosc.pack_array`` role).
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
import zlib
from typing import Optional

import numpy as np

from ..data import _native

SOURCE = os.path.join(os.path.dirname(_native.SOURCE), "codec.cc")
LIB_NAME = "libpscodec.so"
MAGIC = b"PSAR"  # array framing magic (the codec stream has its own 'PSC1')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The loaded codec library, built on first use (raises
    ``NativeBuildError`` when it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            path = _native.build(SOURCE, LIB_NAME)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise _native.NativeBuildError(f"cannot load {path}: {e}") from e
            u8p, size = ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t
            lib.psc_max_compressed.restype = size
            lib.psc_max_compressed.argtypes = [size]
            lib.psc_compress.restype = size
            lib.psc_compress.argtypes = [u8p, size, u8p, size, ctypes.c_int, ctypes.c_int]
            lib.psc_raw_size.restype = size
            lib.psc_raw_size.argtypes = [u8p, size]
            lib.psc_decompress.restype = size
            lib.psc_decompress.argtypes = [u8p, size, u8p, size, ctypes.c_int]
            _lib = lib
        return _lib


def _src(data: bytes):
    """Zero-copy read-only view of ``data`` for the C side."""
    return ctypes.cast(ctypes.c_char_p(data or b"\0"), ctypes.POINTER(ctypes.c_uint8))


def compress_bytes(data: bytes, itemsize: int = 1, n_threads: int = 0) -> bytes:
    """Raw bytes -> ``b"N"`` + the native stream (shuffled by
    ``itemsize``; ``n_threads`` 0 = the library's choice)."""
    lib = load()
    n = len(data)
    cap = lib.psc_max_compressed(n)
    dst = ctypes.create_string_buffer(cap)
    got = lib.psc_compress(_src(data), n, ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
                           cap, itemsize, n_threads)
    if got == 0 and n > 0:
        raise RuntimeError("psc_compress failed")
    return b"N" + ctypes.string_at(dst, got)


def decompress_bytes(blob: bytes, n_threads: int = 0) -> bytes:
    """Inverse of ``compress_bytes``; also reads a ``b"Z"`` zlib blob.
    A damaged stream raises ValueError."""
    tag, payload = blob[:1], blob[1:]
    if tag == b"Z":
        return zlib.decompress(payload)
    if tag != b"N":
        raise ValueError("not a psnative codec blob")
    lib = load()
    src = _src(payload)
    raw = lib.psc_raw_size(src, len(payload))
    if raw == 0:
        # an empty stream or a bad header: the header tells them apart
        if (len(payload) >= 16 and payload[:4] == b"PSC1" and payload[4] == 1
                and int.from_bytes(payload[8:16], "little") == 0):
            return b""
        raise ValueError("malformed psnative stream")
    dst = bytearray(raw)
    got = lib.psc_decompress(
        src, len(payload),
        ctypes.cast((ctypes.c_char * raw).from_buffer(dst), ctypes.POINTER(ctypes.c_uint8)),
        raw, n_threads)
    if got != raw:
        raise ValueError("corrupt psnative stream")
    return bytes(dst)


def compress_array(arr: np.ndarray, n_threads: int = 0) -> bytes:
    """Array -> framed compressed blob (the role of blosc.pack_array)."""
    arr = np.asarray(arr)
    shape = list(arr.shape)  # before ascontiguousarray, which makes 0-d 1-d
    arr = np.ascontiguousarray(arr)
    header = json.dumps({"dtype": arr.dtype.str, "shape": shape}).encode()
    body = compress_bytes(arr.tobytes(), itemsize=arr.dtype.itemsize, n_threads=n_threads)
    return MAGIC + len(header).to_bytes(4, "little") + header + body


def decompress_array(blob: bytes, n_threads: int = 0) -> np.ndarray:
    if blob[:4] != MAGIC:
        raise ValueError("not a psnative array blob")
    hlen = int.from_bytes(blob[4:8], "little")
    meta = json.loads(blob[8:8 + hlen].decode())
    raw = decompress_bytes(blob[8 + hlen:], n_threads=n_threads)
    return np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(meta["shape"]).copy()


# the reference's names (compression.py:18-46): gradients and weights
def g_compress(grad: np.ndarray) -> bytes:
    return compress_array(grad)


def g_decompress(msg: bytes) -> np.ndarray:
    return decompress_array(msg)


def w_compress(weight: np.ndarray) -> bytes:
    return compress_array(weight)


def w_decompress(msg: bytes) -> np.ndarray:
    return decompress_array(msg)
