"""Stage spill and resume: partitioned intermediates on disk.

Counterpart of ``hash_join_codes_knl_tpu/engine/spill.py``.  Any
partitioned intermediate (the null-padded partition-contiguous layout of
ops/radix_partition.py) can be written to disk and resumed, so a failed
multi-stage job restarts from its last completed stage instead of the
raw relations.  Every stage is a pure function of its inputs, so
resume-then-rerun is always sound.

Format: raw little-endian uint32 files (native/relio.cpp, parallel) plus
one JSON sidecar with the shape, the partition counts and the u64
checksums of both columns (write.cpp:1635-1645 semantics).  The files
hold the JAX package's domain, scrambled uint32 keys with 0 as the null
key, so a spill written by either package resumes in the other and the
checksums agree.  The port's biased keys (utils/hashing.py) are
unbiased before every write and biased after every read.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import native
from ..utils.hashing import bias, to_numpy_u32, u32_to_device, unbias
from ..utils.host import u64sum
from .phj import _run_device


def _write_u32(path: str, arr: np.ndarray) -> None:
    if native.relio_available():
        native.write_u32(path, arr)
    else:
        np.ascontiguousarray(arr, dtype=np.uint32).astype("<u4").tofile(path)


def _read_u32(path: str, n: int) -> np.ndarray:
    if native.relio_available():
        return native.read_u32(path, n)
    out = np.fromfile(path, dtype="<u4", count=n)
    if len(out) != n:
        raise ValueError(f"{path} truncated")
    return out.astype(np.uint32)


def spill_partitions(directory: str, stage: str, hk: torch.Tensor,
                     vals: torch.Tensor, counts: torch.Tensor,
                     meta: dict | None = None) -> str:
    """Persist one partitioned intermediate: biased int32 keys (pads are
    the biased null key), int32 value bits and the partition counts.
    Returns the sidecar path."""
    os.makedirs(directory, exist_ok=True)
    hk = to_numpy_u32(unbias(hk))
    vals = to_numpy_u32(vals)
    counts = counts.cpu().numpy().astype(np.uint32)
    _write_u32(os.path.join(directory, f"{stage}_hk.bin"), hk)
    _write_u32(os.path.join(directory, f"{stage}_val.bin"), vals)
    sidecar = os.path.join(directory, f"{stage}.json")
    with open(sidecar, "w") as f:
        # caller meta first: the computed integrity fields win a key
        # collision (a caller's own 'counts' or 'n' would corrupt or
        # falsely reject every resume)
        json.dump(
            {
                **(meta or {}),
                "stage": stage,
                "n": int(hk.shape[0]),
                "partitions": int(counts.shape[0]),
                "counts": counts.tolist(),
                "checksum": u64sum(hk),
                "val_checksum": u64sum(vals),
            },
            f,
        )
    return sidecar


def resume_partitions(directory: str, stage: str, device=None):
    """Load a spilled intermediate; returns (hk, vals, counts, meta) with
    hk the biased int32 keys, vals the int32 value bits and counts int32,
    all on `device`, by default the card (RuntimeError where there is
    none; "cpu" loads to the host).

    Both column checksums are verified on load: silent on-disk
    corruption raises ValueError, it is not joined.  A sidecar without
    the value checksum is rejected the same way."""
    with open(os.path.join(directory, f"{stage}.json")) as f:
        meta = json.load(f)
    device = _run_device(device)
    hk = _read_u32(os.path.join(directory, f"{stage}_hk.bin"), meta["n"])
    vals = _read_u32(os.path.join(directory, f"{stage}_val.bin"), meta["n"])
    got = u64sum(hk)
    if got != meta["checksum"]:
        raise ValueError(
            f"spill {stage}: checksum mismatch ({got} != {meta['checksum']})"
        )
    got_v = u64sum(vals)
    if got_v != meta.get("val_checksum"):
        raise ValueError(
            f"spill {stage}: val checksum mismatch "
            f"({got_v} != {meta.get('val_checksum')})"
        )
    counts = torch.tensor(meta["counts"], dtype=torch.int32, device=device)
    return (bias(u32_to_device(hk, device)), u32_to_device(vals, device),
            counts, meta)
