"""The native relation generator (C++ via ctypes).

The generator's rejection sampler and Fisher-Yates shuffle are sequential
by contract (one RNG stream, write.cpp:1579-1585), so the only way to
produce multi-hundred-million-row relations quickly is native code.  The
library is built on demand from ``gen.cpp`` (the same source as the JAX
package's) with the system g++, into the package's git-ignored
``_build/`` directory, named by a hash of the source, and written to a
temporary file and renamed, so a half-written library is never loaded.
Without a compiler, ``relgen.generate`` falls back to the Python
generator, which gives the same bytes.
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
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_CMD = ("g++", "-O2", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Path of the generator library built from the current source."""
    h = hashlib.sha256(" ".join(_CMD).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhjkgen_{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([*_CMD, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
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
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


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

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))

    rc = lib.hjk_generate(
        seed & 0xFFFFFFFF,
        inner_tuples,
        outer_tuples,
        selc,
        zipf,
        _MODES[mode],
        f_inner & 0xFFFFFFFF,
        f_outer & 0xFFFFFFFF,
        p32(ik),
        p32(iv),
        p32(ok),
        p32(ov),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != 0:
        raise RuntimeError(f"hjk_generate failed with code {rc}")
    return ik, iv, ok, ov, {
        "inner_checksum": int(meta[0]),
        "outer_checksum": int(meta[1]),
        "join_distinct": int(meta[2]),
    }
