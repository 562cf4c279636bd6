"""Native host components (C++ via ctypes): the relation generator and
the relation file IO.

The generator's rejection sampler and Fisher-Yates shuffle are sequential
by contract (one RNG stream, write.cpp:1579-1585), so the only way to
produce multi-hundred-million-row relations quickly is native code.  The
relation IO (``relio.cpp``) reads and writes raw uint32 files striped
over threads and sums uint32 words into the u64 checksum.  Both
libraries are built on demand from their sources (the same sources as
the JAX package's) with the system g++, into the package's git-ignored
``_build/`` directory, each named by a hash of its source and command,
and written to a temporary file and renamed, so a half-written library
is never loaded.  Without a compiler, ``relgen.generate`` falls back to
the Python generator, which gives the same bytes, and ``relation.py``
to numpy's file IO.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gen.cpp")
_RELIO_SRC = os.path.join(_DIR, "relio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_CMD = ("g++", "-O2", "-shared", "-fPIC")
_RELIO_CMD = (*_CMD, "-pthread")
_lock = threading.Lock()
_libs: dict = {}  # library name -> CDLL, or None once a build failed


def _library_path(name: str, src: str, cmd) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def library_path() -> str:
    """Path of the generator library built from the current source."""
    return _library_path("hjkgen", _SRC, _CMD)


def relio_library_path() -> str:
    """Path of the relation IO library built from the current source."""
    return _library_path("hjkrelio", _RELIO_SRC, _RELIO_CMD)


def _build(src: str, cmd, path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([*cmd, "-o", tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare_gen(lib) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.hjk_generate.restype = ctypes.c_int
    lib.hjk_generate.argtypes = [
        ctypes.c_uint32,  # seed
        ctypes.c_uint64,  # inner_tuples
        ctypes.c_uint64,  # outer_tuples
        ctypes.c_double,  # selc
        ctypes.c_double,  # zipf
        ctypes.c_int,     # mode
        ctypes.c_uint32,  # f_inner
        ctypes.c_uint32,  # f_outer
        u32p, u32p, u32p, u32p,
        ctypes.POINTER(ctypes.c_uint64),
    ]


def _declare_relio(lib) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    for fn in (lib.hjk_read_u32, lib.hjk_write_u32):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, u32p, ctypes.c_uint64, ctypes.c_int]
    lib.hjk_checksum_u32.restype = ctypes.c_uint64
    lib.hjk_checksum_u32.argtypes = [u32p, ctypes.c_uint64, ctypes.c_int]


def _load_lib(name: str, src: str, cmd, declare):
    """The library `name`, built on first use; None where it cannot be
    built or loaded (tried once a process)."""
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None
        path = _library_path(name, src, cmd)
        if not os.path.exists(path) and not _build(src, cmd, path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        declare(lib)
        _libs[name] = lib
        return lib


def _load():
    return _load_lib("hjkgen", _SRC, _CMD, _declare_gen)


def _load_relio():
    return _load_lib("hjkrelio", _RELIO_SRC, _RELIO_CMD, _declare_relio)


def available() -> bool:
    return _load() is not None


def relio_available() -> bool:
    return _load_relio() is not None


def _io_threads() -> int:
    return min(16, os.cpu_count() or 1)


def _p32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def read_u32(path: str, n: int) -> np.ndarray:
    """Parallel raw-u32 file read (relio.cpp); raises IOError on a
    missing, short or unreadable file."""
    lib = _load_relio()
    if lib is None:
        raise RuntimeError("native relio library unavailable")
    out = np.empty(n, dtype=np.uint32)
    rc = lib.hjk_read_u32(path.encode(), _p32(out), n, _io_threads())
    if rc != 0:
        raise IOError(f"hjk_read_u32({path!r}) failed with code {rc}")
    return out


def write_u32(path: str, arr: np.ndarray) -> None:
    """Parallel raw-u32 file write (relio.cpp); raises IOError on
    failure."""
    lib = _load_relio()
    if lib is None:
        raise RuntimeError("native relio library unavailable")
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    rc = lib.hjk_write_u32(path.encode(), _p32(arr), arr.size,
                           _io_threads())
    if rc != 0:
        raise IOError(f"hjk_write_u32({path!r}) failed with code {rc}")


def checksum_u32(arr: np.ndarray) -> int:
    """u64 wraparound sum of u32 words (write.cpp:1635-1645 semantics)."""
    lib = _load_relio()
    if lib is None:
        raise RuntimeError("native relio library unavailable")
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    return int(lib.hjk_checksum_u32(_p32(arr), arr.size, _io_threads()))


_MODES = {"ref": 0, "uniform": 1, "zipf": 2}


def generate_native(
    seed: int,
    inner_tuples: int,
    outer_tuples: int,
    selc: float,
    zipf: float,
    mode: str,
    f_inner: int,
    f_outer: int,
):
    """Returns (inner_keys, inner_vals, outer_keys, outer_vals, meta) or
    raises RuntimeError if the native library is unavailable or failed."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native generator library unavailable")
    ik = np.empty(inner_tuples, dtype=np.uint32)
    iv = np.empty(inner_tuples, dtype=np.uint32)
    ok = np.empty(outer_tuples, dtype=np.uint32)
    ov = np.empty(outer_tuples, dtype=np.uint32)
    meta = np.zeros(3, dtype=np.uint64)

    rc = lib.hjk_generate(
        seed & 0xFFFFFFFF,
        inner_tuples,
        outer_tuples,
        selc,
        zipf,
        _MODES[mode],
        f_inner & 0xFFFFFFFF,
        f_outer & 0xFFFFFFFF,
        _p32(ik),
        _p32(iv),
        _p32(ok),
        _p32(ov),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise RuntimeError(f"hjk_generate failed with code {rc}")
    return ik, iv, ok, ov, {
        "inner_checksum": int(meta[0]),
        "outer_checksum": int(meta[1]),
        "join_distinct": int(meta[2]),
    }
