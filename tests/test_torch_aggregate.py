"""The port's hash aggregate (ops/aggregate.py) against the JAX package's
on the CPU, with zero tolerance: group counts, and group keys, sums and
counts slot for slot over the whole output (pad tails included), for
all six entry points and the run reduction they share."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hash_join_codes_knl_tpu.ops.aggregate as jagg
from hash_join_codes_knl_tpu.engine.phj import join as jax_join
from hash_join_codes_knl_tpu_torch.engine.phj import join
from hash_join_codes_knl_tpu_torch.ops import aggregate as tagg
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    to_numpy_u32,
    u32_to_device,
)

EDGE_KEYS = np.array([0, 1, 0xFFFFFFFF, 0xFFFFFFFE, 2**31, 2**31 - 1],
                     np.uint32)


def _t(a):
    return u32_to_device(a, "cpu")


def _host(x):
    """A port output as numpy: int32 bit tensors as uint32, the rest as
    they are."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32 and x.dim():
            return to_numpy_u32(x)
        return x.numpy()
    return np.asarray(x)


def _same(port, ref, counts_at=3):
    """Port outputs equal to JAX outputs slot for slot: scalars by
    value, key and sum columns as uint32 bits, counts as int32."""
    assert len(port) == len(ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        r = np.asarray(r)
        if r.ndim == 0:
            assert int(p) == int(r), i
        elif i == counts_at:
            assert p.dtype == torch.int32
            np.testing.assert_array_equal(p.numpy(), r, err_msg=str(i))
        else:
            np.testing.assert_array_equal(_host(p), r.astype(np.uint32),
                                          err_msg=str(i))


def _keys_vals(seed, n, groups, null_share=0.05, edge=True):
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(1, 2**32, groups + 64,
                                  dtype=np.uint32))[:groups]
    if edge:
        k = min(len(pool), len(EDGE_KEYS) - 1)
        pool[:k] = EDGE_KEYS[1 : k + 1]
    keys = pool[rng.integers(0, len(pool), n)].astype(np.uint32)
    keys[rng.random(n) < null_share] = 0
    # values near 2^32: every group sum wraps
    vals = rng.integers(2**32 - 2**20, 2**32, n, dtype=np.uint32)
    return keys, vals


def _both(name, keys, vals, **kw):
    port = getattr(tagg, name)(_t(keys), _t(vals), **kw)
    ref = getattr(jagg, name)(jnp.asarray(keys), jnp.asarray(vals), **kw)
    return port, ref


@pytest.mark.parametrize("n,groups", [(8192, 700), (5000, 4999), (1, 1),
                                      (777, 3)])
def test_hash_aggregate_slot_for_slot(n, groups):
    keys, vals = _keys_vals(3 + n, n, groups)
    port, ref = _both("hash_aggregate", keys, vals)
    _same(port, ref)
    # the wraparound sums are the u32 sums of each group
    g = int(port[0])
    gk, gs = _host(port[1])[:g], _host(port[2])[:g]
    for k, s in zip(gk[:20], gs[:20]):
        assert s == np.uint32(vals[keys == k].astype(np.uint64).sum()
                              % 2**32)


def test_hash_aggregate_edge_keys_and_nulls():
    """Keys 0 (null), 1 and 0xFFFFFFFF: 1 sorts first, 0xFFFFFFFF last,
    nulls nowhere."""
    keys = np.tile(EDGE_KEYS, 50)
    vals = np.arange(keys.size, dtype=np.uint32) * np.uint32(0x9E3779B1)
    port, ref = _both("hash_aggregate", keys, vals)
    _same(port, ref)
    g = int(port[0])
    assert g == len(EDGE_KEYS) - 1
    gk = _host(port[1])
    assert gk[0] == 1 and gk[g - 1] == 0xFFFFFFFF and not gk[g:].any()


@pytest.mark.parametrize("keys", [np.zeros(0, np.uint32),
                                  np.zeros(300, np.uint32)],
                         ids=["empty", "all-null"])
def test_hash_aggregate_empty_and_all_null(keys):
    vals = np.arange(keys.size, dtype=np.uint32)
    port, ref = _both("hash_aggregate", keys, vals)
    _same(port, ref)
    assert int(port[0]) == 0


@pytest.mark.parametrize("n,groups,chunks", [(8192, 400, 8), (8000, 77, 16),
                                             (5000, 4999, 4)])
def test_hash_aggregate_chunked_slot_for_slot(n, groups, chunks):
    keys, vals = _keys_vals(23 + n, n, groups)
    port, ref = _both("hash_aggregate_chunked", keys, vals, chunks=chunks,
                      partial_cap=chunks * -(-n // chunks))
    _same(port, ref)
    assert int(port[4]) == 0
    single = tagg.hash_aggregate(_t(keys), _t(vals))
    g = int(single[0])
    assert int(port[0]) == g
    for p, s in zip(port[1:4], single[1:4]):
        assert torch.equal(p[:g], s[:g])


def test_hash_aggregate_chunked_overflow_like_jax():
    rng = np.random.default_rng(29)
    keys = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    vals = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    port, ref = _both("hash_aggregate_chunked", keys, vals, chunks=4,
                      partial_cap=256)
    _same(port, ref)
    assert int(port[4]) == 2048 - 256


def test_hash_aggregate_chunked_empty():
    e = np.zeros(0, np.uint32)
    port, ref = _both("hash_aggregate_chunked", e, e, chunks=4,
                      partial_cap=64)
    _same(port, ref)


def _spied_auto(monkeypatch, keys, vals, **kw):
    """hash_aggregate_auto with its two engines counted."""
    calls = {"single": 0, "chunked": 0}
    for name, key in (("hash_aggregate", "single"),
                      ("hash_aggregate_chunked", "chunked")):
        def spy(*a, _fn=getattr(tagg, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tagg, name, spy)
    return tagg.hash_aggregate_auto(_t(keys), _t(vals), **kw), calls


@pytest.mark.parametrize("distinct,want_calls", [
    (512, {"single": 0, "chunked": 2}),  # re-planned chunked pass
    (2048, {"single": 1, "chunked": 1}),  # groups ~ rows: single-level
])
def test_hash_aggregate_auto_replan_like_jax(monkeypatch, distinct,
                                             want_calls):
    rng = np.random.default_rng(67 + distinct)
    pool = np.unique(rng.integers(1, 2**32, 3000,
                                  dtype=np.uint32))[:distinct]
    n = 8192 if distinct == 512 else 2048
    keys = pool[rng.integers(0, distinct, n)] if distinct == 512 else pool
    keys = keys.astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    ref = jagg.hash_aggregate_auto(keys, vals, chunks=4, partial_cap=256)
    port, calls = _spied_auto(monkeypatch, keys, vals, chunks=4,
                              partial_cap=256)
    assert calls == want_calls
    _same(port, ref)


def test_reduce_runs_batched_like_jax():
    """The shared run reduction on (C, m) rows with two value columns,
    an all-null row and wrapping sums."""
    rng = np.random.default_rng(31)
    C, m = 4, 512
    keys = rng.integers(1, 40, (C, m)).astype(np.uint32)
    keys[1, ::3] = 0xFFFFFFFF
    keys[2] = 0
    va = rng.integers(2**31, 2**32, (C, m), dtype=np.uint32)
    vb = rng.integers(0, 2**32, (C, m), dtype=np.uint32)
    jk, ja, jb = jagg._null_last_sort(jnp.asarray(keys),
                                      (jnp.asarray(va), jnp.asarray(vb)),
                                      dimension=1)
    tk, ta, tb = tagg._null_last_sort(_t(keys.ravel()).view(C, m),
                                      (_t(va.ravel()).view(C, m),
                                       _t(vb.ravel()).view(C, m)))
    np.testing.assert_array_equal(_host(tk.reshape(-1)).reshape(C, m),
                                  np.asarray(jk))
    jgk, (jsa, jsb), jc, jg = jagg._reduce_runs(jk, (ja, jb))
    tgk, (tsa, tsb), tc, tg = tagg._reduce_runs(tk, (ta, tb))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for t, j in ((tgk, jgk), (tsa, jsa), (tsb, jsb)):
        np.testing.assert_array_equal(_host(t.reshape(-1)),
                                      np.asarray(j).reshape(-1))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _mn_data(seed=61):
    rng = np.random.default_rng(seed)
    base = np.unique(rng.integers(1, 2**32, 900, dtype=np.uint32))[:512]
    reps = rng.integers(1, 7, 512)
    ik = np.repeat(base, reps).astype(np.uint32)
    iv = rng.integers(2**32 - 2**24, 2**32, len(ik), dtype=np.uint32)
    ok = base[rng.integers(0, 512, 4096)].astype(np.uint32)
    ok[::17] = rng.integers(1, 2**32, ok[::17].size, dtype=np.uint32)
    ov = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    return ik, iv, ok, ov


@pytest.fixture(scope="module")
def mn_results():
    cols = _mn_data()
    res_t, _ = join(*cols, device="cpu")
    res_j, _ = jax_join(*cols)
    assert int(res_t.match_cnts.max()) > 1
    return cols, res_t, res_j


@pytest.mark.parametrize("kw", [{}, {"block_rows": 512},
                                {"block_rows": 2048, "partial_budget": 128}],
                         ids=["one-block", "blocks", "budget-replan"])
def test_aggregate_join_result_expanded_like_jax(mn_results, kw):
    (ik, iv, _, _), res_t, res_j = mn_results
    port = tagg.aggregate_join_result_expanded(res_t, ik, iv, **kw)
    ref = jagg.aggregate_join_result_expanded(res_j, ik, iv, **kw)
    _same(port, ref)


def test_aggregate_join_result_refuses_mn(mn_results):
    _, res_t, _ = mn_results
    with pytest.raises(ValueError, match="multi-match"):
        tagg.aggregate_join_result(res_t)


def test_aggregate_join_result_aligned_like_jax_and_expanded():
    """1:1 data: the aligned aggregate equals JAX's slot for slot, and
    the expanded form gives the same groups."""
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate

    inner, outer, _ = generate(seed=43, inner_tuples=512,
                               outer_tuples=8192, mode="uniform")
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    res_t, _ = join(*cols, device="cpu")
    res_j, _ = jax_join(*cols)
    port = tagg.aggregate_join_result(res_t)
    _same(port, jagg.aggregate_join_result(res_j))
    exp = tagg.aggregate_join_result_expanded(res_t, inner.keys, inner.vals,
                                              block_rows=1024)
    g = int(port[0])
    assert int(exp[0]) == g
    for p, e in zip(port[1:], exp[1:]):
        assert torch.equal(p[:g], e[:g])


def test_aggregate_join_result_empty_result():
    """No probe matches: zero groups from both forms."""
    ik = np.arange(1, 257, dtype=np.uint32)
    ok = np.arange(1000, 1000 + 2048, dtype=np.uint32)
    res_t, _ = join(ik, ik, ok, ok, device="cpu")
    res_j, _ = jax_join(ik, ik, ok, ok)
    _same(tagg.aggregate_join_result(res_t), jagg.aggregate_join_result(res_j))
    _same(tagg.aggregate_join_result_expanded(res_t, ik, ik),
          jagg.aggregate_join_result_expanded(res_j, ik, ik))
