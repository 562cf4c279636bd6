"""Multi-column relations over the (u32 key, u32 payload) engine core.

Counterpart of ``hash_join_codes_knl_tpu/engine/columns.py``.  The
reference's data model is one u32 value per tuple (hj.h); this layer
generalizes to any number of named columns without touching the
kernels: the join runs with each side's row index as its payload, and
the matched index pairs materialize the columns on the host with numpy
fancy indexing.

Column dtypes are unconstrained.  The join key is u32, or u64 through
``join_columns_u64`` (folded to the u32 engine domain and verified
exactly on the host), or a tuple of integer columns through
``join_columns_multi``.  ``how`` is "inner", "left", "semi" or "anti".
1:1 joins read the matched build index straight from the aligned
result; duplicate-key builds go through the M:N expansion
(``materialize_expanded``) with the index payload.  No kernel is this
layer's own: ``join`` runs K1 and K2 or K3 (engine/phj.py).  ``device``
is the card by default; "cpu" runs the plain versions.
"""

from __future__ import annotations

import numpy as np

from ..utils.hashing import to_numpy_u32
from .phj import join, materialize_expanded

# Wider keys (beyond the reference's u32 contract, hj.h:24-29): a u64
# key folds to the engine's u32 domain with a Fibonacci-style mix; the
# engine joins the FOLDED keys with row-index payloads, and the exact
# u64 equality check runs host-side on the candidate pairs (a fold
# collision only ever ADDS candidates -- equal u64 keys always fold
# equal -- so filtering is exact).  Expected extra candidates at fold
# load n/2^32 are ~n_pairs * n/2^32: negligible below billions of rows.
_FOLD_C1 = np.uint64(0x9E3779B97F4A7C15)  # 2^64 / phi, odd
_FOLD_C2 = np.uint64(0xC2B2AE3D27D4EB4F)  # xxhash64 prime 2, odd


def fold_key64(k64: np.ndarray) -> np.ndarray:
    """u64 -> nonzero u32 fold.  Odd-constant multiplies are bijections
    of u64, so the high-32 extraction mixes every input bit; 0 is
    remapped off the engine's reserved null key (the remap can only add
    candidate pairs, never lose one: the map stays a pure function)."""
    k64 = np.ascontiguousarray(k64, np.uint64)
    h = (k64 * _FOLD_C1) ^ ((k64 * _FOLD_C2) >> np.uint64(29))
    h32 = (h >> np.uint64(32)).astype(np.uint32)
    return np.where(h32 == 0, np.uint32(0x9E3779B9), h32)


_HOWS = ("inner", "left", "semi", "anti")


def _index_pairs(inner_keys, outer_keys, plan, need_pairs: bool = True,
                 need_sets: bool = False, device=None):
    """Run the engine with row-index payloads; returns (out_o, out_i,
    semi_o, anti_o, plan): the matched (outer index, inner index) pairs
    (exact M:N) and, only with need_sets, the outer row indices with at
    least one match and with none, read off the aligned layout (inner
    mode skips those masks).  need_pairs=False skips the M:N expansion
    and returns None pairs."""
    ni = len(inner_keys)
    no = len(outer_keys)
    i_idx = np.arange(ni, dtype=np.uint32)
    o_idx = np.arange(no, dtype=np.uint32)
    res, plan = join(inner_keys, i_idx, outer_keys, o_idx, plan,
                     device=device)
    mc = res.match_cnts.cpu().numpy()
    semi_o = anti_o = None
    pv = None
    if need_sets:
        # pads carry probe key 0 (never a real key here) and probe
        # value 0, a legitimate row index: liveness is read off the
        # recovered keys, not the payloads
        live = to_numpy_u32(res.probe_keys) != 0
        pv = to_numpy_u32(res.probe_vals)
        semi_o = pv[live & (mc > 0)]
        anti_o = pv[live & (mc == 0)]
    if not need_pairs:
        return None, None, semi_o, anti_o, plan
    if mc.max(initial=0) <= 1:
        m = mc == 1
        if pv is None:
            pv = to_numpy_u32(res.probe_vals)
        out_o = pv[m]  # outer row index
        out_i = to_numpy_u32(res.match_vals)[m]  # inner row index
    else:
        # expansion with index payloads: rows (key, outer idx, inner idx)
        # for every matching pair
        _, out_o, out_i = materialize_expanded(res, inner_keys, i_idx)
    return out_o, out_i, semi_o, anti_o, plan


def _materialize_cols(inner_cols, outer_cols, out_o, out_i, semi_o,
                      anti_o, how: str, left_fill):
    """Assemble named output columns from matched index pairs (+ the
    semi/anti rows).  Name clashes prefix with 'outer_'/'inner_'
    exactly as join_columns documents."""
    out_cols = {}
    both = set(inner_cols) & set(outer_cols)
    if how == "semi":
        # one output row per qualifying outer row, outer columns only
        for name, col in outer_cols.items():
            out_cols[name] = np.asarray(col)[semi_o]
        return out_cols
    if how == "anti":
        for name, col in outer_cols.items():
            out_cols[name] = np.asarray(col)[anti_o]
        return out_cols
    if how == "left":
        o_rows = np.concatenate([out_o, anti_o])
        n_anti = len(anti_o)
        for name, col in outer_cols.items():
            key = f"outer_{name}" if name in both else name
            out_cols[key] = np.asarray(col)[o_rows]
        for name, col in inner_cols.items():
            key = f"inner_{name}" if name in both else name
            col = np.asarray(col)
            fill = np.full(n_anti, left_fill, dtype=col.dtype)
            out_cols[key] = np.concatenate([col[out_i], fill])
        return out_cols
    for name, col in outer_cols.items():
        key = f"outer_{name}" if name in both else name
        out_cols[key] = np.asarray(col)[out_o]
    for name, col in inner_cols.items():
        key = f"inner_{name}" if name in both else name
        out_cols[key] = np.asarray(col)[out_i]
    return out_cols


def join_columns(
    inner_keys: np.ndarray,
    inner_cols: dict,
    outer_keys: np.ndarray,
    outer_cols: dict,
    plan=None,
    how: str = "inner",
    left_fill=0,
    device=None,
):
    """Multi-column equi-join; returns (out_cols, plan).

    out_cols maps every name in outer_cols / inner_cols to a materialized
    result column (outer columns first on name clashes, prefixed with
    'outer_'/'inner_' only when both sides share a name).

    how: "inner" (default) -- one row per (probe row, matching build
    row) pair, exact M:N.  "left" -- inner rows plus one row per
    unmatched outer row with inner columns filled with `left_fill`
    (cast to each column's dtype).  "semi" -- one row per outer row
    with >= 1 match, OUTER columns only.  "anti" -- one row per outer
    row with NO match, outer columns only.  semi/anti never run the
    M:N expansion: they read match counts off the aligned engine
    layout directly.
    """
    if how not in _HOWS:
        raise ValueError(f"how must be one of {_HOWS}, got {how!r}")
    # key 0 is the engine's reserved null slot: a real key-0 row would
    # be treated as padding -- invisible to matching AND silently absent
    # from left/anti output.  The fold+verify path remaps 0 off the
    # null slot and filters candidates exactly, so route such inputs
    # through it (one cheap host pass decides; the common 0-free case
    # pays nothing else).
    if (np.asarray(outer_keys) == 0).any() or \
            (np.asarray(inner_keys) == 0).any():
        return join_columns_u64(inner_keys, inner_cols, outer_keys,
                                outer_cols, plan, how, left_fill, device)
    out_o, out_i, semi_o, anti_o, plan = _index_pairs(
        inner_keys, outer_keys, plan,
        need_pairs=how in ("inner", "left"),
        need_sets=how != "inner", device=device,
    )
    return (
        _materialize_cols(inner_cols, outer_cols, out_o, out_i, semi_o,
                          anti_o, how, left_fill),
        plan,
    )


def _verified_pairs(ifold, ofold, n_outer, plan, verify, device=None):
    """Candidate pairs from the FOLDED u32 join, filtered by the exact
    host-side predicate `verify(out_o, out_i) -> bool mask`.  A fold
    collision only ever ADDS candidates (equal keys always fold equal),
    so filtering is exact -- and semi/anti sets are derived from the
    VERIFIED pairs, never the folded aligned layout (a collision there
    would misclassify an anti row as matched)."""
    out_o, out_i, _, _, plan = _index_pairs(ifold, ofold, plan,
                                            device=device)
    keep = verify(out_o, out_i)
    out_o, out_i = out_o[keep], out_i[keep]
    matched = np.zeros(n_outer, bool)
    matched[out_o] = True
    semi_o = np.flatnonzero(matched).astype(np.int64)
    anti_o = np.flatnonzero(~matched).astype(np.int64)
    return out_o, out_i, semi_o, anti_o, plan


def join_columns_u64(
    inner_keys: np.ndarray,
    inner_cols: dict,
    outer_keys: np.ndarray,
    outer_cols: dict,
    plan=None,
    how: str = "inner",
    left_fill=0,
    device=None,
):
    """Multi-column equi-join on u64 KEYS; same contract as
    join_columns (incl. `how` modes).  The device core still runs
    entirely in its u32 domain (folded keys + row-index payloads -- no
    wide-word kernels); candidate pairs from fold collisions are
    removed by one host-side u64 equality pass, so the output is the
    exact u64 join."""
    if how not in _HOWS:
        raise ValueError(f"how must be one of {_HOWS}, got {how!r}")
    ik64 = np.ascontiguousarray(inner_keys, np.uint64)
    ok64 = np.ascontiguousarray(outer_keys, np.uint64)
    out_o, out_i, semi_o, anti_o, plan = _verified_pairs(
        fold_key64(ik64), fold_key64(ok64), len(ok64), plan,
        lambda o, i: ik64[i] == ok64[o], device,
    )
    return (
        _materialize_cols(inner_cols, outer_cols, out_o, out_i, semi_o,
                          anti_o, how, left_fill),
        plan,
    )


# between-column mix constants for composite keys (odd, from xxhash64 /
# splitmix64): the combine must distinguish (a, b) from (b, a)
_MIX_C3 = np.uint64(0xFF51AFD7ED558CCD)


def combine_key_columns(key_cols) -> np.ndarray:
    """Fold a tuple of integer key COLUMNS into one u64 composite key.
    Equal tuples always combine equal (pure function); unequal tuples
    may collide -- callers verify candidates exactly, column by column.
    Column order matters ((a, b) and (b, a) mix differently)."""
    cols = [np.asarray(c) for c in key_cols]
    if not cols:
        raise ValueError("need at least one key column")
    n = len(cols[0])
    h = np.full(n, np.uint64(0x9E3779B97F4A7C15), np.uint64)
    for c in cols:
        if c.dtype.kind not in "iub":
            raise TypeError(
                f"composite key columns must be integer/bool, got {c.dtype}"
            )
        if len(c) != n:
            raise ValueError("key columns must share one length")
        # two's-complement wrap for signed inputs: deterministic and
        # injective per column, which is all the combine needs
        h ^= (c.astype(np.uint64) + np.uint64(1)) * _FOLD_C1
        h = (h ^ (h >> np.uint64(29))) * _MIX_C3
    return h


def join_columns_multi(
    inner_key_cols,
    inner_cols: dict,
    outer_key_cols,
    outer_cols: dict,
    plan=None,
    how: str = "inner",
    left_fill=0,
    device=None,
):
    """Equi-join on a COMPOSITE key (a tuple of integer columns per
    side, matched positionally); same output contract as join_columns
    (incl. `how` modes).  The key tuple folds to u64 then to the u32
    engine domain; candidates are verified host-side column by column,
    so the output is the exact composite-key join."""
    if how not in _HOWS:
        raise ValueError(f"how must be one of {_HOWS}, got {how!r}")
    ikc = [np.asarray(c) for c in inner_key_cols]
    okc = [np.asarray(c) for c in outer_key_cols]
    if len(ikc) != len(okc):
        raise ValueError(
            f"key column count mismatch: {len(ikc)} inner vs "
            f"{len(okc)} outer"
        )
    for pos, (ic, oc) in enumerate(zip(ikc, okc)):
        if ic.dtype != oc.dtype:
            # numpy promotes e.g. int64 == uint64 through float64,
            # which can falsely equate distinct huge values -- the
            # verification pass must stay exact, so demand one dtype
            raise TypeError(
                f"key column {pos}: dtype mismatch {ic.dtype} vs "
                f"{oc.dtype} (cast both sides to one dtype first)"
            )

    def verify(out_o, out_i):
        keep = np.ones(len(out_o), bool)
        for ic, oc in zip(ikc, okc):
            keep &= ic[out_i] == oc[out_o]
        return keep

    out_o, out_i, semi_o, anti_o, plan = _verified_pairs(
        fold_key64(combine_key_columns(ikc)),
        fold_key64(combine_key_columns(okc)),
        len(okc[0]), plan, verify, device,
    )
    return (
        _materialize_cols(inner_cols, outer_cols, out_o, out_i, semi_o,
                          anti_o, how, left_fill),
        plan,
    )
