"""Host-side helper: the u64 wraparound checksum of uint32 words.

Counterpart of ``hash_join_codes_knl_tpu/utils/host.py`` (``u64sum``;
its ``on_tpu`` has no meaning here)."""

from __future__ import annotations

import numpy as np

# below this, thread spawn + ctypes overhead beats numpy's single pass
_NATIVE_MIN = 1 << 20


def u64sum(arr) -> int:
    """u64 wraparound sum of words (write.cpp:1635-1645 checksum
    semantics).  Large u32 arrays go through the native relio library
    when it is available (multi-threaded, about memory bandwidth)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint32 and arr.size >= _NATIVE_MIN:
        from .. import native

        if native.relio_available():
            return native.checksum_u32(arr)
    return int(np.sum(arr.astype(np.uint64), dtype=np.uint64))
