"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` by hand into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds. Each source compiles in its own ``nvcc`` process, all started
together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu
    nvcc -shared -o libps_kernels.so *.o

No ``--use_fast_math``: K1, K2 and K3 must round half to even and
divide exactly (IEEE), as the JAX reference does. ``-Xptxas -v`` makes
ptxas report each kernel's registers, shared memory and spills; the
reports of every source land in ``build.log`` beside the library
(``build_log()``).

The library lands in ``ps_pytorch_tpu_torch/_build/<hash>/`` (listed in
.gitignore), keyed by a hash of the sources and flags, and is built at
first use. A build or load failure raises; there is no plain-version
fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libps_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES: Dict[torch.dtype, int] = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, a source failed to compile, or the library failed
    to load."""


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def library_path() -> str:
    return os.path.join(BUILD_ROOT, _digest(), LIB_NAME)


def build() -> str:
    """Compile csrc/*.cu into the hashed build directory (no-op when the
    library for these sources already exists). Returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_ROOT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-I", CSRC, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        errors, logs = [], []
        for src, _, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{log}")
            if p.returncode != 0:
                errors.append(f"{os.path.basename(src)}:\n{log}")
        if errors:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc] + ARCH_FLAGS + ["-shared", "-o", lib_tmp]
            + [obj for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(os.path.join(os.path.dirname(out), "build.log"), "w") as f:
            f.write("\n".join(logs))
        os.replace(lib_tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def build_log() -> str:
    """nvcc's output (ptxas's per-kernel registers and spills) of the
    build of these sources; empty when the library was not built here."""
    path = os.path.join(os.path.dirname(library_path()), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ps_quantize_kv_write.argtypes = [vp, i32, i32, vp]
    lib.ps_quantize_kv_write.restype = i32
    lib.ps_kv_write_words.argtypes = []
    lib.ps_kv_write_words.restype = i64
    lib.ps_quantize_rows_many.argtypes = [vp, i32, i32, i32, vp, vp]
    lib.ps_quantize_rows_many.restype = i32
    lib.ps_quantize_rows_scaled_many.argtypes = [vp, vp, vp, vp]
    lib.ps_quantize_rows_scaled_many.restype = i32
    lib.ps_rows_table_words.argtypes = []
    lib.ps_rows_table_words.restype = i64
    lib.ps_quantize_tensors.argtypes = [vp, vp, vp, vp]
    lib.ps_quantize_tensors.restype = i32
    lib.ps_absmax_tensors.argtypes = [vp, vp, vp]
    lib.ps_absmax_tensors.restype = i32
    lib.ps_quantize_tensors_given.argtypes = [vp, vp, vp, vp]
    lib.ps_quantize_tensors_given.restype = i32
    lib.ps_rows_scaled_absmax_many.argtypes = [vp, vp, vp]
    lib.ps_rows_scaled_absmax_many.restype = i32
    lib.ps_quantize_rows_scaled_given_many.argtypes = [vp, vp, vp, vp]
    lib.ps_quantize_rows_scaled_given_many.restype = i32
    lib.ps_tensor_table_words.argtypes = []
    lib.ps_tensor_table_words.restype = i64
    lib.ps_accumulate_rescale.argtypes = [vp, i64, i64, vp, vp, vp]
    lib.ps_accumulate_rescale.restype = i32
    lib.ps_flash_fwd.argtypes = (
        [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
         ctypes.POINTER(i64), f32, i32, i32, vp, i32, i32, vp]
    )
    lib.ps_flash_fwd.restype = i32
    lib.ps_flash_bwd_dq.argtypes = (
        [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
         ctypes.POINTER(i64), f32, i32, i32, vp, i32, i32, vp]
    )
    lib.ps_flash_bwd_dq.restype = i32
    lib.ps_flash_bwd_dkv.argtypes = (
        [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
         ctypes.POINTER(i64), f32, i32, i32, vp, i32, i32, vp]
    )
    lib.ps_flash_bwd_dkv.restype = i32
    lib.ps_error_string.argtypes = [i32]
    lib.ps_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _declare(lib)
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load().ps_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
