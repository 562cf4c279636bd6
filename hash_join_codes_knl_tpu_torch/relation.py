"""Relation container and the analytic join cardinality.

The port's copy of what it uses of the JAX package's ``relation.py``: a
relation is two parallel uint32 arrays (keys, vals), as the reference's
``ik_<N>.txt`` / ``iv_<N>.txt`` files hold them (write.cpp:1824-1865).
The on-disk save and load are not part of the port yet.
"""

from __future__ import annotations

import dataclasses

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
