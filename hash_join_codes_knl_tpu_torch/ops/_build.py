"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at the first launch, never at import, so the kernel
modules import on machines without ``nvcc`` or a card.  The library
lands in ``_build/`` beside this package, named by a hash of the
sources and flags, and is written to a temporary file and renamed, so a
stale or half-written library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dynamic shared memory one block may ask for on the H100 (227 KB); the
# wrappers size their kernels' tables and staging areas within it
SMEM_LIMIT = 232_448

_VP, _I64, _U32, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                         ctypes.c_int)
# C entry points (csrc/*.cu): every pointer and the stream are void*
_SIGNATURES = {
    "hjk_flat_to_rows": [_VP, _VP, _I64, _VP, _VP, _I64, _U32, _VP],
    "hjk_merge_probe_dense": [_VP, _I64, _VP, _VP, _I64, _VP, _I64, _I64,
                              _VP, _VP, _I64, _INT, _INT, _INT, _I64, _VP],
    "hjk_merge_probe_gather": [_VP, _I64, _VP, _VP, _I64, _VP, _I64, _I64,
                               _VP, _VP, _I64, _INT, _INT, _VP],
    "hjk_merge_probe_gather_indexed": [_VP, _I64, _VP, _VP, _I64, _VP, _VP,
                                       _I64, _I64, _I64, _VP, _VP, _I64,
                                       _INT, _INT, _VP],
    "hjk_probe_tiles": [_VP, _I64, _I64, _VP, _VP, _I64, _VP, _VP, _VP,
                        _INT, _INT, _INT, _I64, _VP],
    "hjk_radix_histogram": [_VP, _I64, _I64, _I64, _I64, _INT, _INT, _VP,
                            _VP],
    "hjk_radix_scatter": [_VP, _VP, _I64, _I64, _I64, _I64, _INT, _INT,
                          _VP, _VP, _VP, _INT, _VP],
    "hjk_mul_u32": [_VP, _I64, _VP, _U32, _U32, _U32, _VP],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None
# what the last build did: seconds spent compiling (0.0 when a cached
# library was loaded) and ptxas' report of registers and shared memory
build_info: dict = {}


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    """Path of the library built from the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhjk_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in _sources() if s.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, path)
        build_info.update(seconds=time.perf_counter() - t0,
                          ptxas=proc.stderr)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed.
    Raises if there is no CUDA device or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port's CUDA kernels need a CUDA device; none is "
                "available (CPU tensors take the plain PyTorch versions)"
            )
        path = library_path()
        if os.path.exists(path):
            build_info.update(seconds=0.0, ptxas="")
        else:
            _compile(path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point `name` on `device`'s current stream, tensors
    passed as their data pointers; raise if the launch was refused (the
    entry point returns cudaGetLastError())."""
    fn = getattr(library(), name)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's ``launches`` count, where it
    launches its kernel.  Under a lock: thread ranks (parallel/
    distributed.py thread_meshes) launch concurrently, and a bare += can
    lose an update."""
    with _count_lock:
        wrapper.launches += 1
