"""The port's multi-column joins (engine/columns.py) against the JAX
package's join_columns, join_columns_u64 and join_columns_multi on the
CPU.  Exact: the same output column names, and the same rows compared
as sorted row sets (row order follows each engine's probe sort), for
the four join modes, u64 keys with forced fold collisions, composite
keys, and key-0 rows; fold_key64 and combine_key_columns bit for bit."""

import numpy as np
import pytest

import hash_join_codes_knl_tpu.engine.columns as jcols
import hash_join_codes_knl_tpu_torch.engine.columns as tcols

HOWS = ["inner", "left", "semi", "anti"]


def _row_set(out: dict) -> list:
    """The output as a sorted list of row tuples, columns by name."""
    names = sorted(out)
    cols = [np.asarray(out[n]).tolist() for n in names]
    lengths = {len(c) for c in cols}
    assert len(lengths) == 1, lengths
    return sorted(zip(*cols))


def _agree(fn_name, *args, **kw):
    got, _ = getattr(tcols, fn_name)(*args, device="cpu", **kw)
    want, _ = getattr(jcols, fn_name)(*args, **kw)
    assert sorted(got) == sorted(want)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
    rows = _row_set(got)
    assert rows == _row_set(want)
    return rows


def _mn_workload(seed=31):
    """Heavy build-key duplication (M:N) plus probe misses."""
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 300, 900, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, 900, 2000)],
                         rng.integers(1, 2**32, 700, dtype=np.uint32)])
    inner_cols = {"iv": np.arange(900, dtype=np.int64) + 1,
                  "flag": rng.integers(0, 2, 900, dtype=np.int8)}
    outer_cols = {"ov": np.arange(len(ok), dtype=np.int64) + 1,
                  "flag": rng.random(len(ok)).astype(np.float32)}
    return ik, inner_cols, ok.astype(np.uint32), outer_cols


@pytest.mark.parametrize("how", HOWS)
def test_modes_mn_like_jax(how):
    ik, inner_cols, ok, outer_cols = _mn_workload()
    rows = _agree("join_columns", ik, inner_cols, ok, outer_cols, how=how,
                  left_fill=-1)
    assert rows


@pytest.mark.parametrize("how", ["inner", "left"])
def test_unique_build_like_jax(how):
    rng = np.random.default_rng(11)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    ok = np.concatenate([ik[rng.integers(0, 2048, 6000)],
                         rng.integers(1, 2**32, 1000, dtype=np.uint32)])
    _agree("join_columns", ik, {"price": rng.random(2048),
                                "name": ik.astype(np.uint64) * 3},
           ok.astype(np.uint32),
           {"qty": rng.integers(1, 9, len(ok), dtype=np.int16)}, how=how)


@pytest.mark.parametrize("how", HOWS)
def test_key_zero_rows_like_jax(how):
    ik = np.array([0, 5, 9, 5], np.uint32)
    ok = np.array([0, 5, 7, 0, 9], np.uint32)
    _agree("join_columns", ik, {"iv": np.arange(4, dtype=np.int64) + 1},
           ok, {"ov": np.arange(5, dtype=np.int64) + 1}, how=how)


def _fold_collisions(seed, pairs):
    """`pairs` distinct u64 key pairs that fold to one u32 engine key
    each (a birthday search over the real fold)."""
    rng = np.random.default_rng(seed)
    sample = rng.integers(1, 2**64, 400_000, dtype=np.uint64)
    h = tcols.fold_key64(sample)
    np.testing.assert_array_equal(h, jcols.fold_key64(sample))
    vals, counts = np.unique(h, return_counts=True)
    a, b = [], []
    for dv in vals[counts >= 2]:
        pair = np.unique(sample[h == dv])[:2]
        if len(pair) == 2:
            a.append(pair[0])
            b.append(pair[1])
        if len(a) == pairs:
            break
    assert len(a) == pairs, "need fold collisions for this test"
    return np.array(a, np.uint64), np.array(b, np.uint64)


@pytest.mark.parametrize("how", HOWS)
def test_u64_with_forced_fold_collisions_like_jax(how):
    """The build side holds keys a, the probe side their fold-colliding
    twins b (never a match) and the a's (each a match), plus repeats."""
    a, b = _fold_collisions(41, 6)
    ik = np.concatenate([a, a[:2]])
    ok = np.concatenate([b, a, b[:3], a[3:]])
    rows = _agree("join_columns_u64", ik,
                  {"iv": np.arange(len(ik), dtype=np.int64) + 1}, ok,
                  {"ov": np.arange(len(ok), dtype=np.int64) + 1}, how=how)
    if how == "anti":
        assert [r[0] for r in rows] == \
            list(range(1, len(b) + 1)) + list(range(13, 16))


@pytest.mark.parametrize("how", HOWS)
def test_multi_key_like_jax(how):
    rng = np.random.default_rng(53)
    ik1 = rng.integers(0, 40, 600, dtype=np.int32)
    ik2 = rng.integers(-20, 20, 600, dtype=np.int64)
    sel = rng.integers(0, 600, 1500)
    ok1, ok2 = ik1[sel].copy(), ik2[sel].copy()
    ok2[rng.random(1500) < 0.33] += 1000  # one column off: no match
    _agree("join_columns_multi", (ik1, ik2),
           {"iv": np.arange(600, dtype=np.int64) + 1}, (ok1, ok2),
           {"ov": np.arange(1500, dtype=np.int64) + 1}, how=how)
    np.testing.assert_array_equal(tcols.combine_key_columns((ik1, ik2)),
                                  jcols.combine_key_columns((ik1, ik2)))


def test_refusals_like_jax():
    k = np.array([1, 2], dtype=np.int64)
    u = np.array([1, 2], dtype=np.uint64)
    for mod in (tcols, jcols):
        with pytest.raises(TypeError, match="dtype mismatch"):
            mod.join_columns_multi((k,), {"iv": k}, (u,), {"ov": u})
        with pytest.raises(ValueError, match="count mismatch"):
            mod.join_columns_multi((k, k), {"iv": k}, (k,), {"ov": k})
        with pytest.raises(ValueError, match="how must be one of"):
            mod.join_columns(k.astype(np.uint32), {}, k.astype(np.uint32),
                             {}, how="outer")
