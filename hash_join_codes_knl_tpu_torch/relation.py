"""Relation container and the reference's on-disk format.

The port's copy of the JAX package's ``relation.py`` (numpy only).  A
relation is two parallel raw little-endian uint32 arrays (keys, vals)
stored as ``ik_<N>.txt`` / ``iv_<N>.txt`` for the inner side and
``ok_<N>.txt`` / ``ov_<N>.txt`` for the outer side (write.cpp:1824-1865;
consumed by the join binaries at phj.cpp:2077-2111).  The files are
byte-identical to the JAX package's, so either package reads what the
other wrote.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class Relation:
    keys: np.ndarray  # uint32[n]
    vals: np.ndarray  # uint32[n]

    def __post_init__(self):
        assert self.keys.dtype == np.uint32 and self.vals.dtype == np.uint32
        assert self.keys.shape == self.vals.shape and self.keys.ndim == 1

    def __len__(self) -> int:
        return len(self.keys)

    @property
    def checksum(self) -> int:
        """uint64 wraparound sum of keys (write.cpp:1524-1537 semantics)."""
        from .utils.host import u64sum

        return u64sum(self.keys)


def _names(side: str, n: int) -> tuple[str, str]:
    p = "i" if side == "inner" else "o"
    return f"{p}k_{n}.txt", f"{p}v_{n}.txt"


def save_relation(rel: Relation, side: str, directory: str,
                  prefer_native: bool = True) -> tuple[str, str]:
    """Write `rel` as the `side` ("inner" or "outer") relation's two
    files in `directory`; returns their paths."""
    from . import native

    kpath, vpath = (os.path.join(directory, f)
                    for f in _names(side, len(rel)))
    if prefer_native and native.relio_available():
        native.write_u32(kpath, rel.keys)
        native.write_u32(vpath, rel.vals)
    else:
        rel.keys.astype("<u4").tofile(kpath)
        rel.vals.astype("<u4").tofile(vpath)
    return kpath, vpath


def load_relation(side: str, n: int, directory: str,
                  prefer_native: bool = True) -> Relation:
    """Read the `side` relation of `n` tuples from `directory`.  Missing
    files raise FileNotFoundError; a file shorter than n words raises
    ValueError."""
    from . import native

    kpath, vpath = (os.path.join(directory, f) for f in _names(side, n))
    if not (os.path.exists(kpath) and os.path.exists(vpath)):
        raise FileNotFoundError(f"relation files for {side}/{n} missing")
    if prefer_native and native.relio_available():
        try:
            return Relation(native.read_u32(kpath, n),
                            native.read_u32(vpath, n))
        except IOError as e:
            raise ValueError(str(e)) from e
    keys = np.fromfile(kpath, dtype="<u4", count=n)
    vals = np.fromfile(vpath, dtype="<u4", count=n)
    if len(keys) != n or len(vals) != n:
        raise ValueError(f"relation files for {side}/{n} are truncated")
    return Relation(keys.astype(np.uint32), vals.astype(np.uint32))


def expected_join_tuples(inner: int, outer: int, selc: float = 1.0) -> int:
    """Analytic expected join cardinality (npj.cpp:937-942).

    distinct = min(inner, outer); join_distinct = distinct * selc;
    join = (outer/odist) * (inner/idist) * join_distinct, truncated.
    """
    inner_distinct = min(inner, outer)
    outer_distinct = min(inner, outer)
    join_distinct = int(min(inner_distinct, outer_distinct) * selc)
    outer_repeats = outer / outer_distinct
    inner_repeats = inner / inner_distinct
    return int(outer_repeats * inner_repeats * join_distinct)
