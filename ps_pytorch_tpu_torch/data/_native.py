"""The port's binding of the native batch gather (``native/loader.cc``
``psl_gather``: dst[i] = src[indices[i]] over rows of ``item_bytes``,
threaded above 4 MB), through ``ctypes``.

The source is compiled as it stands with the host C++ compiler:

    c++ -O3 -std=c++17 -fPIC -shared -pthread native/loader.cc -o libpsloader.so

into ``ps_pytorch_tpu_torch/_build/<hash>/`` (listed in .gitignore),
keyed by a hash of the source's bytes, the compiler and the flags, at
first use. The flags are portable (no ``-march=native``), so a library
built on one machine loads on another. A missing compiler, a failed
build or a failed load raises ``NativeBuildError``: nothing falls back
to numpy indexing. This binding never loads the JAX package's
``_native/libpsnative.so``. ``build(source, lib_name)`` compiles another
source of ``native/`` the same way (ops/codec.py: ``native/codec.cc``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "loader.cc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libpsloader.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing, a ``native/`` source failed to
    compile, or the library failed to load."""


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise NativeBuildError("no C++ compiler found ($CXX, c++, g++, clang++ on PATH)")


def library_path(source: str = SOURCE, lib_name: str = LIB_NAME) -> str:
    """Where ``source``'s library lives: keyed by a hash of its bytes,
    the compiler and the flags."""
    if not os.path.exists(source):
        raise NativeBuildError(f"{source} is missing")
    cxx = _cxx()
    h = hashlib.sha256(" ".join([cxx] + CXX_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], lib_name)


def build(source: str = SOURCE, lib_name: str = LIB_NAME) -> str:
    """Compile ``source`` (default ``native/loader.cc``; a no-op when
    this hash's library exists); returns the library's path."""
    out = library_path(source, lib_name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        lib_tmp = os.path.join(tmp, lib_name)
        proc = subprocess.run([_cxx()] + CXX_FLAGS + [source, "-o", lib_tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"c++ failed on {source}:\n{proc.stdout}")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        os.replace(lib_tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def load() -> ctypes.CDLL:
    """The loaded gather library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
            p8, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
            lib.psl_gather.argtypes = [p8, i64, i64, ctypes.POINTER(i64), i64, p8,
                                       ctypes.c_int]
            lib.psl_gather.restype = ctypes.c_int
            _lib = lib
        return _lib
