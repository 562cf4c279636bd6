"""Pure-Python/numpy relation generator: the portable parity oracle.

The port's copy of the JAX package's ``relgen/_pygen.py``, unchanged.

Reproduces the reference generator's single-thread behavior *bit-exactly*
(write.cpp:1482-1646 with threads=1): one MT19937-32 stream feeds, in order,
(1) rejection-sampled distinct keys (write.cpp:1442-1468 `unique`: key==0 and
duplicates rejected, each candidate consumes one draw), (2) uniform repeat
picks for the inner side (write.cpp:1526-1538), (3) the outer-side walk,
(4) Fisher-Yates shuffles of inner then outer keys (write.cpp:1429-1440,
1579-1585).  Values are ``key * factor`` with 32-bit wraparound
(write.cpp:1588-1622).

Outer-side modes
----------------
``ref``      Bit-exact transcription of the reference T=1 walk.  Note the
             reference initializes the Zipf walk at rank 0, whose pmf is
             +inf, so for T=1 the walk degenerates for *any* zipf value to:
             outer key o < O-1 takes pool[o+1], and the last key is one
             uniform pick (one draw).  Only well-defined for outer <= inner
             (otherwise the reference reads out of bounds, see SURVEY.md
             section 0 bit-rot notes).  zipf is ignored, as in the reference.
``uniform``  The intended uniform semantics, mirroring the (well-defined)
             inner loop: first outer_distinct keys sequential from the pool,
             the rest uniform picks (one draw each).
``zipf``     The intended rank-frequency semantics with the rank-0 and
             off-by-one bugs fixed, made cross-implementation deterministic
             by integer-exact count math: rank r in [1, R] gets weight
             w_r = floor(2^40 * r^-zipf) (scalar libm pow), and
             count_r = max(1, O * w_r // sum(w)); ranks are assigned to pool
             entries in order until O keys are emitted, remaining keys are
             uniform picks.  R = min(outer_distinct, 1_000_000), matching the
             reference's total_ranks cap (write.cpp:1547).
"""

from __future__ import annotations

import math

import numpy as np

from ..relation import Relation
from ..utils.mt19937 import MT19937

_U32 = np.uint32
_U64 = np.uint64

ZIPF_RANK_CAP = 1_000_000
_ZIPF_WEIGHT_SCALE = 1 << 40


def _mulhi(r: np.ndarray, n: int) -> np.ndarray:
    """(r * n) >> 32 -- the reference's uniform index pick (write.cpp:1534)."""
    return ((r.astype(_U64) * _U64(n)) >> _U64(32)).astype(np.int64)


def unique_fill(gen: MT19937, count: int) -> np.ndarray:
    """Rejection-sampled distinct nonzero uint32 keys (write.cpp:1442-1468).

    Acceptance depends only on set membership (key != 0 and not seen), never
    on the hash-table probe path, so the key sequence is independent of the
    table geometry and can be produced in vectorized batches that consume
    exactly one draw per candidate, like the scalar loop.
    """
    out = np.empty(count, dtype=_U32)
    seen = np.empty(0, dtype=_U32)
    filled = 0
    while filled < count:
        batch = gen.take(count - filled)  # cannot overshoot: accepts <= draws
        ok = batch != 0
        _, first_idx = np.unique(batch, return_index=True)
        first = np.zeros(len(batch), dtype=bool)
        first[first_idx] = True
        if len(seen):
            first &= ~np.isin(batch, seen)
        acc = batch[ok & first]
        out[filled : filled + len(acc)] = acc
        seen = np.concatenate([seen, acc])
        filled += len(acc)
    return out


def fisher_yates(data: np.ndarray, gen: MT19937) -> None:
    """In-place shuffle, draw-for-draw identical to write.cpp:1429-1440.

    The swap target sequence j_i = i + ((r_i * (n-i)) >> 32) is data
    independent, so all draws are taken vectorized; applying the swaps is
    inherently sequential (this is why the native C++ path exists for large
    relations -- see native/gen.cpp).
    """
    n = len(data)
    if n == 0:
        return
    r = gen.take(n).astype(_U64)
    sizes = _U64(n) - np.arange(n, dtype=_U64)
    j = ((r * sizes) >> _U64(32)) + np.arange(n, dtype=_U64)
    j = j.astype(np.int64)
    for i in range(n):
        t = data[i]
        data[i] = data[j[i]]
        data[j[i]] = t


def zipf_rank_counts(outer_tuples: int, outer_distinct: int, zipf: float):
    """Integer-exact per-rank repeat counts for the `zipf` mode."""
    nranks = min(outer_distinct, ZIPF_RANK_CAP)
    weights = [
        int(_ZIPF_WEIGHT_SCALE * math.pow(r, -zipf)) for r in range(1, nranks + 1)
    ]
    base = sum(weights)
    counts = np.maximum(
        1,
        np.array(
            [outer_tuples * w // base for w in weights], dtype=np.int64
        ),
    )
    cum = np.cumsum(counts)
    cut = int(np.searchsorted(cum, outer_tuples))
    if cut < nranks:
        counts = counts[: cut + 1].copy()
        counts[cut] = outer_tuples - (cum[cut - 1] if cut else 0)
        if counts[cut] == 0:
            counts = counts[:cut]
    return counts  # sum(counts) <= outer_tuples; remainder is uniform picks


def default_factors(seed: int) -> tuple[int, int, int, int, int]:
    """Deterministic replacement for the reference's srand(time)/rand odd
    factors (write.cpp:1737-1740): five odd u32 from an independent stream."""
    g = MT19937((seed ^ 0x9E3779B9) & 0xFFFFFFFF)
    return tuple(int((x << 1) | 1) & 0xFFFFFFFF for x in g.take(5))


def generate_py(
    seed: int,
    inner_tuples: int,
    outer_tuples: int,
    selc: float = 1.0,
    zipf: float = 0.0,
    mode: str = "ref",
    factors=None,
) -> tuple[Relation, Relation, dict]:
    if factors is None:
        factors = default_factors(seed)
    f_unique, f_thread, f_inner, f_outer, f_extra = factors

    inner_distinct = min(inner_tuples, outer_tuples)
    outer_distinct = min(inner_tuples, outer_tuples)
    join_distinct = int(min(inner_distinct, outer_distinct) * selc)
    distinct = inner_distinct + outer_distinct - join_distinct

    gen = MT19937(seed)
    pool = unique_fill(gen, distinct)

    # inner keys: distinct slice then uniform repeats (write.cpp:1526-1538)
    inner_keys = np.empty(inner_tuples, dtype=_U32)
    inner_keys[:inner_distinct] = pool[:inner_distinct]
    extra = inner_tuples - inner_distinct
    if extra:
        idx = _mulhi(gen.take(extra), inner_distinct)
        inner_keys[inner_distinct:] = pool[idx]

    # outer keys
    outer_pool = pool[inner_distinct - join_distinct :]
    assert len(outer_pool) == outer_distinct
    outer_keys = np.empty(outer_tuples, dtype=_U32)
    if mode == "ref":
        if outer_tuples != outer_distinct:
            raise ValueError(
                "mode='ref' requires outer <= inner (the reference walk reads "
                "out of bounds otherwise); use mode='uniform' or 'zipf'"
            )
        # u = o+1 every iteration; last key is one uniform pick.
        outer_keys[: outer_tuples - 1] = outer_pool[1:outer_tuples]
        idx = _mulhi(gen.take(1), outer_distinct)
        outer_keys[outer_tuples - 1] = outer_pool[idx[0]]
    elif mode == "uniform":
        outer_keys[:outer_distinct] = outer_pool[:outer_distinct]
        extra = outer_tuples - outer_distinct
        if extra:
            idx = _mulhi(gen.take(extra), outer_distinct)
            outer_keys[outer_distinct:] = outer_pool[idx]
    elif mode == "zipf":
        counts = zipf_rank_counts(outer_tuples, outer_distinct, zipf)
        fixed = int(counts.sum())
        outer_keys[:fixed] = np.repeat(outer_pool[: len(counts)], counts)
        extra = outer_tuples - fixed
        if extra:
            idx = _mulhi(gen.take(extra), outer_distinct)
            outer_keys[fixed:] = outer_pool[idx]
    else:
        raise ValueError(f"unknown mode {mode!r}")

    inner_checksum = int(np.sum(inner_keys.astype(_U64), dtype=_U64))
    outer_checksum = int(np.sum(outer_keys.astype(_U64), dtype=_U64))

    # thread-0 shuffles: inner then outer from the same stream
    # (write.cpp:1579-1585)
    fisher_yates(inner_keys, gen)
    fisher_yates(outer_keys, gen)

    inner_vals = inner_keys * _U32(f_inner)
    outer_vals = outer_keys * _U32(f_outer)

    meta = {
        "inner_checksum": inner_checksum,
        "outer_checksum": outer_checksum,
        "inner_distinct": inner_distinct,
        "outer_distinct": outer_distinct,
        "join_distinct": join_distinct,
        "factors": tuple(factors),
        "mode": mode,
        "seed": seed,
        "zipf": zipf,
        "selc": selc,
    }
    return Relation(inner_keys, inner_vals), Relation(outer_keys, outer_vals), meta
