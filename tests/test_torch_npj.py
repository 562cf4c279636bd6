"""The port's NPJ (engine/npj.py) against the JAX package's, on the CPU:
range_hash bit for bit, the built table slot for slot, both probe
engines and both output orders, the re-plans and the edge cases of
tests/test_npj.py.  Zero tolerance.  Under order="sorted" the JAX sort is
unstable, so probe values agree as a multiset of (key, value) pairs;
keys, match values and counts agree slot for slot."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import hash_join_codes_knl_tpu.engine.npj as jnpj
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.relgen.generate import generate
from hash_join_codes_knl_tpu.utils.hashing import np_range_hash
from hash_join_codes_knl_tpu.utils.hashing import range_hash as jax_range
from hash_join_codes_knl_tpu_torch.engine import npj as tnpj
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    range_hash,
    to_numpy_u32,
    u32_to_device,
    unbias,
)


def _t(a):
    return u32_to_device(np.asarray(a, np.uint32), "cpu")


def _jplan(plan):
    return jnpj.NpjPlan(**dataclasses.asdict(plan))


def _same_plan(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---- range_hash --------------------------------------------------------


@pytest.mark.parametrize("nbins", [1, 2, 3, 100, 1000, 12345, 1 << 16,
                                   (1 << 16) + 1, 1 << 20, 1 << 25,
                                   (1 << 31) - 1, 1 << 31, (1 << 32) - 1])
@pytest.mark.parametrize("factor", [0x9E3779B1, 1, 0xFFFFFFFF])
def test_range_hash_bit_exact(nbins, factor):
    rng = np.random.default_rng(nbins % 1000)
    keys = np.concatenate([[0, 1, 2, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF],
                           rng.integers(0, 2**32, 5000, dtype=np.uint32)]
                          ).astype(np.uint32)
    got = range_hash(_t(keys), factor, nbins)
    assert got.dtype == torch.int64
    want = np_range_hash(keys, factor, nbins).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_range(jnp.asarray(keys), factor,
                                          nbins)).astype(np.int64))
    assert int(got.min()) >= 0 and int(got.max()) < nbins


def test_range_hash_refuses_bad_nbins():
    for nbins in (0, 1 << 32):
        with pytest.raises(ValueError):
            range_hash(_t([1, 2]), 3, nbins)


# ---- plans and the build -------------------------------------------------


def test_plans_match():
    for n in (1, 3, 1000, 4096, 1_000_000, 16_000_000):
        _same_plan(tnpj.plan_npj(n), jnpj.plan_npj(n))
        _same_plan(tnpj.plan_npj(n, load=0.75), jnpj.plan_npj(n, load=0.75))
    for plan in (tnpj.NpjPlan(buckets=1 << 13), tnpj.NpjPlan(
            buckets=1 << 17, tile=512), tnpj.plan_npj(4_000_000)):
        j = _jplan(plan)
        assert plan.table_size == j.table_size
        assert plan.max_window == j.max_window
        for probes in (1, 2048, 16_000_000, 256_000_000):
            for disp in (0, 384, 5000):
                assert plan.auto_window(probes, disp) == \
                    j.auto_window(probes, disp)


def _build_both(ik, iv, plan):
    got = tnpj.npj_build(_t(ik), _t(iv), plan)
    want = jnpj.npj_build(jnp.asarray(ik), jnp.asarray(iv), _jplan(plan))
    return got, want


@pytest.mark.parametrize("case", ["unique", "duplicates_nulls", "overflow"])
def test_build_table_slot_for_slot(case):
    rng = np.random.default_rng(40)
    plan = tnpj.plan_npj(3000, load=0.75)
    if case == "unique":
        ik = rng.integers(1, 2**32, 3000, dtype=np.uint32)
    elif case == "duplicates_nulls":
        ik = rng.integers(0, 700, 3000, dtype=np.uint32)  # key 0: nulls
    else:
        # one bucket's keys, more than the margin can park
        plan = tnpj.NpjPlan(buckets=1 << 10, margin=128)
        pool = rng.integers(1, 2**32, 400_000, dtype=np.uint32)
        ik = pool[np_range_hash(pool, plan.factor, plan.buckets) >= 1000]
        ik = ik[:1500]
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    (tk, tv, ovf, disp), (jk, jv, jovf, jdisp) = _build_both(ik, iv, plan)
    np.testing.assert_array_equal(to_numpy_u32(unbias(tk)), np.asarray(jk))
    np.testing.assert_array_equal(to_numpy_u32(tv), np.asarray(jv))
    assert int(ovf) == int(jovf) and int(disp) == int(jdisp)
    assert (int(ovf) > 0) == (case == "overflow")


# ---- joins ---------------------------------------------------------------


def _rows(ik, iv, ok, ov, mv, mc):
    m = np.asarray(mc) == 1
    return multiset_digest(ok[m], ov[m], np.asarray(mv)[m])


def _join_both(ik, iv, ok, ov, plan=None, order="input"):
    got = tnpj.npj_join(ik, iv, ok, ov, plan, order=order, device="cpu")
    want = jnpj.npj_join(ik, iv, ok, ov,
                         None if plan is None else _jplan(plan),
                         order=order)
    _same_plan(got[-1], want[-1])
    if order == "sorted":
        k, v, mv, mc = (to_numpy_u32(got[0]), to_numpy_u32(got[1]),
                        to_numpy_u32(got[2]), got[3].numpy())
        jk, jv, jmv, jmc = (np.asarray(x) for x in want[:4])
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(mv, jmv)
        np.testing.assert_array_equal(mc, jmc)
        pairs = lambda a, b: np.sort(a.astype(np.uint64) << 32 | b)
        np.testing.assert_array_equal(pairs(k, v), pairs(jk, jv))
        return k, v, mv, mc, got[-1]
    mv, mc = to_numpy_u32(got[0]), got[1].numpy()
    np.testing.assert_array_equal(mv, np.asarray(want[0]))
    np.testing.assert_array_equal(mc, np.asarray(want[1]))
    return mv, mc, got[-1]


@pytest.mark.parametrize("kw", [
    dict(inner_tuples=4096, outer_tuples=4096, mode="ref"),
    dict(inner_tuples=1024, outer_tuples=8192, mode="uniform"),
    dict(inner_tuples=1024, outer_tuples=8192, mode="zipf", zipf=1.0),
], ids=["ref", "uniform", "zipf"])
@pytest.mark.parametrize("order", ["input", "sorted"])
def test_join_matches_jax_and_oracle(kw, order):
    inner, outer, _ = generate(seed=37, prefer_native=False, **kw)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    out = _join_both(*cols, order=order)
    want = multiset_digest(*join_oracle(*cols))
    if order == "sorted":
        k, v, mv, mc, _ = out
        assert _rows(None, None, k, v, mv, mc) == want
        assert mc[k == 0].sum() == 0 and (k != 0).sum() == len(outer)
    else:
        assert _rows(*cols, *out[:2]) == want


def _dup_relations(seed):
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 4000, 3000, dtype=np.uint32)  # many duplicates
    iv = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, 3000, 5000)],
                         rng.integers(1, 2**32, 3000, dtype=np.uint32)]
                        ).astype(np.uint32)
    ok[::97] = 0  # null probes
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    return ik, iv, ok, ov


@pytest.mark.parametrize("order", ["input", "sorted"])
def test_duplicate_build_keys_both_orders(order):
    out = _join_both(*_dup_relations(77), order=order)
    assert out[-2].max() > 1  # M:N counts


def test_duplicate_build_keys_counted():
    ik = np.array([5, 5, 9], dtype=np.uint32)
    iv = np.array([1, 2, 3], dtype=np.uint32)
    ok = np.array([5, 9, 7], dtype=np.uint32)
    mv, mc, _ = _join_both(ik, iv, ok, ok)
    np.testing.assert_array_equal(mc, [2, 1, 0])
    assert mv[0] == 2  # max of the matched values


@pytest.mark.parametrize("unique", [False, True])
def test_chain_walk_matches_jax_and_sorted(unique):
    ik, iv, ok, ov = _dup_relations(78)
    if unique:
        ik = np.unique(ik)
        iv = iv[: len(ik)]
    mv0, mc0, plan = _join_both(ik, iv, ok, ov)
    chain = dataclasses.replace(plan, probe_impl="chain", window=0,
                                unique=unique)
    mv1, mc1, _ = _join_both(ik, iv, ok, ov, chain)
    np.testing.assert_array_equal(mc1, mc0)
    np.testing.assert_array_equal(mv1, mv0)
    # the chain walk alone, on the built table
    tk, tv, _, _ = tnpj.npj_build(_t(ik), _t(iv), chain)
    mv2, mc2 = tnpj.npj_probe(tk, tv, _t(ok), chain)
    np.testing.assert_array_equal(mc2.numpy(), mc0)
    with pytest.raises(ValueError, match="sorted probe engine only"):
        tnpj.npj_join(ik, iv, ok, ov, chain, order="sorted", device="cpu")


def test_window_replan_like_jax():
    rng = np.random.default_rng(78)
    ik = np.unique(rng.integers(1, 2**32, 5000, dtype=np.uint32))[:4096]
    iv = ik * np.uint32(3)
    ok = ik[rng.integers(0, 4096, 8192)].astype(np.uint32)
    plan = tnpj.plan_npj(4096)
    tk, tv, _, disp = tnpj.npj_build(_t(ik), _t(iv), plan)
    _, _, wovf = tnpj.npj_probe_sorted(tk, tv, _t(ok), plan, disp, 128)
    jk, jv, _, jdisp = jnpj.npj_build(jnp.asarray(ik), jnp.asarray(iv),
                                      _jplan(plan))
    assert int(wovf) == int(jnpj.npj_probe_sorted(
        jk, jv, jnp.asarray(ok), _jplan(plan), jdisp, 128)[2]) > 0
    mv, mc, final = _join_both(ik, iv, ok, ok,
                               dataclasses.replace(plan, window=128))
    assert mc.sum() == 8192 and final.window > 128


def test_tile_shrink_replan_like_jax():
    plan = tnpj.NpjPlan(buckets=1 << 17)
    rng = np.random.default_rng(13)
    ik = np.unique(rng.integers(1, 2**32, 400_000, dtype=np.uint32))[:100_000]
    iv = np.arange(len(ik), dtype=np.uint32) + 1
    ok = ik[rng.integers(0, len(ik), 2048)].astype(np.uint32)
    mv, mc, final = _join_both(ik, iv, ok, ok, plan)
    assert final.tile < 2048 and mc.min() == 1
    np.testing.assert_array_equal(mv, iv[np.searchsorted(ik, ok)])


def test_explicit_window_wider_than_table():
    rng = np.random.default_rng(81)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = ik * np.uint32(5)
    ok = np.concatenate([ik[rng.integers(0, 2048, 3000)],
                         rng.integers(1, 2**32, 1096, dtype=np.uint32)]
                        ).astype(np.uint32)
    plan = tnpj.plan_npj(2048)
    tk, tv, _, disp = tnpj.npj_build(_t(ik), _t(iv), plan)
    huge = tk.shape[0] * 4
    mv, mc, wovf = tnpj.npj_probe_sorted(tk, tv, _t(ok), plan, disp, huge)
    jk, jv, _, jdisp = jnpj.npj_build(jnp.asarray(ik), jnp.asarray(iv),
                                      _jplan(plan))
    jmv, jmc, jwovf = jnpj.npj_probe_sorted(jk, jv, jnp.asarray(ok),
                                            _jplan(plan), jdisp, huge)
    assert int(wovf) == int(jwovf) == 0
    np.testing.assert_array_equal(mc.numpy(), np.asarray(jmc))
    np.testing.assert_array_equal(to_numpy_u32(mv), np.asarray(jmv))
    assert _rows(ik, iv, ok, ok, to_numpy_u32(mv), mc.numpy()) == \
        multiset_digest(*join_oracle(ik, iv, ok, ok))


def test_span_clamps_to_table_end():
    plan = tnpj.NpjPlan(buckets=1 << 13)
    rng = np.random.default_rng(9)
    pool = np.unique(rng.integers(1, 2**32, 400_000, dtype=np.uint32))
    h0 = np_range_hash(pool, plan.factor, plan.buckets)
    mid = pool[(h0 >= 2000) & (h0 < 2200)][:4500]  # one dense cluster
    tail = pool[h0 == plan.buckets - 1][:2]  # keys at the last bucket
    ik = np.concatenate([mid, tail]).astype(np.uint32)
    iv = np.arange(len(ik), dtype=np.uint32) + 1
    _, _, ovf, disp = tnpj.npj_build(_t(ik), _t(iv), plan)
    assert int(ovf) == 0 and int(disp) > plan.margin  # the premise
    ok = np.concatenate([tail, mid[:100]]).astype(np.uint32)
    mv, mc, _ = _join_both(ik, iv, ok, ok, plan)
    assert mc.min() == 1


def test_const_tile_bucket_collision(monkeypatch):
    """One hot key filling a tile, with a bucket-colliding key in the
    middle: the port's probe equals the JAX kernel's (interpret mode,
    with its constant-tile fast path) and the collider gets its own row."""
    rng = np.random.default_rng(5)
    ik = np.unique(rng.integers(1, 2**32, 60_000, dtype=np.uint32))[:32768]
    iv = (np.arange(len(ik), dtype=np.uint32) + 1) * np.uint32(7)
    plan = tnpj.plan_npj(len(ik))
    h0 = np_range_hash(ik, plan.factor, plan.buckets)
    order = np.argsort(h0, kind="stable")
    dup = np.flatnonzero(np.diff(h0[order]) == 0)
    a, b = ik[order[dup[0]]], ik[order[dup[0] + 1]]
    ok = np.full(plan.tile, a, np.uint32)
    ok[plan.tile // 2] = b
    tk, tv, _, disp = tnpj.npj_build(_t(ik), _t(iv), plan)
    window = plan.auto_window(len(ok), disp=int(disp) + 128)
    mv, mc, wovf = tnpj.npj_probe_sorted(tk, tv, _t(ok), plan, disp, window)
    jk, jv, _, jdisp = jnpj.npj_build(jnp.asarray(ik), jnp.asarray(iv),
                                      _jplan(plan))
    monkeypatch.setattr(jnpj, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        jmv, jmc, jwovf = jnpj.npj_probe_sorted(
            jk, jv, jnp.asarray(ok), _jplan(plan), jdisp, window)
    assert int(wovf) == int(jwovf) == 0
    np.testing.assert_array_equal(mc.numpy(), np.asarray(jmc))
    np.testing.assert_array_equal(to_numpy_u32(mv), np.asarray(jmv))
    i_b = plan.tile // 2
    assert mc[i_b] == 1 and int(to_numpy_u32(mv)[i_b]) == int(iv[ik == b][0])


def test_join_refusals():
    ik = np.array([5, 9], np.uint32)
    with pytest.raises(ValueError, match="order"):
        tnpj.npj_join(ik, ik, ik, ik, order="bogus", device="cpu")
    with pytest.raises(RuntimeError, match="margin"):
        rng = np.random.default_rng(3)
        plan = tnpj.NpjPlan(buckets=1 << 10, margin=128)
        pool = rng.integers(1, 2**32, 400_000, dtype=np.uint32)
        hot = pool[np_range_hash(pool, plan.factor, plan.buckets) >= 1000]
        tnpj.npj_join(hot[:1500], hot[:1500], ik, ik, plan, device="cpu")
