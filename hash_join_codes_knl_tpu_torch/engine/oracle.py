"""Golden join semantics: the portable definition of a correct result.

The port's copy of the JAX package's ``engine/oracle.py`` (numpy only).
The reference join binaries emit, for every (outer tuple, matching inner
tuple) pair, a three-column row (outer key, outer payload, inner payload)
-- npj.cpp:296-317 and the scalar tail at npj.cpp:344-347.  Output ORDER
is nondeterministic there, so equality of results is defined on the row
multiset: this module holds the numpy oracle and an O(1)-comparable
multiset digest for at-scale verification.
"""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def join_oracle(
    inner_keys: np.ndarray,
    inner_vals: np.ndarray,
    outer_keys: np.ndarray,
    outer_vals: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All matching rows as (outer_key, outer_val, inner_val) columns."""
    order = np.argsort(inner_keys, kind="stable")
    sk = inner_keys[order]
    sv = inner_vals[order]
    lo = np.searchsorted(sk, outer_keys, "left").astype(np.int64)
    hi = np.searchsorted(sk, outer_keys, "right").astype(np.int64)
    cnt = hi - lo
    total = int(cnt.sum())
    out_o = np.repeat(np.arange(len(outer_keys), dtype=np.int64), cnt)
    group_start = np.repeat(np.cumsum(cnt) - cnt, cnt)
    ipos = np.repeat(lo, cnt) + (np.arange(total, dtype=np.int64) - group_start)
    return outer_keys[out_o], outer_vals[out_o], sv[ipos]


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: order-independent row hashing needs each row's
    hash to be well mixed before summation."""
    x = x.astype(_U64)
    x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
    return x ^ (x >> _U64(31))


def multiset_digest(
    keys: np.ndarray, vals: np.ndarray, tabs: np.ndarray
) -> tuple[int, int, int]:
    """(count, sum of row hashes mod 2^64, a second independent sum):
    equal digests <=> equal row multisets w.h.p.

    The row hash chains the mix per column, so every input bit passes
    through a full finalizer before the next column is folded in (a
    single xor of shifted columns collides: u32 columns shifted by 21/42
    overlap and high tab bits fall off the u64 top).
    """
    h = _mix64(_mix64(_mix64(keys.astype(_U64)) ^ vals.astype(_U64))
               ^ tabs.astype(_U64))
    s1 = int(np.sum(h, dtype=_U64))
    s2 = int(np.sum(_mix64(h + _U64(0x9E3779B97F4A7C15)), dtype=_U64))
    return len(keys), s1, s2
