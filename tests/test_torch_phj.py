"""The port's join() against the JAX package's join() on the CPU.

Same inputs, same plan; the results must agree exactly: probe keys,
match values and match counts slot for slot, probe values as a multiset
(the JAX probe sort is unstable), build_counts, the final plan after any
re-plan, join_tuples modulo 2^32, and the materialized rows' digest
against the numpy oracle."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import hash_join_codes_knl_tpu.engine.phj as jphj
import hash_join_codes_knl_tpu.ops.chunk_layout as jcl
import hash_join_codes_knl_tpu.ops.merge_probe_gather as jmg
import hash_join_codes_knl_tpu.ops.merge_probe_pallas as jmp
from hash_join_codes_knl_tpu.engine.config import plan_join as jax_plan_join
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.relgen.generate import generate
from hash_join_codes_knl_tpu.utils.hashing import mod_inverse_u32
from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine.config import (
    DEFAULT_FACTOR,
    JoinPlan,
    plan_join,
)
from hash_join_codes_knl_tpu_torch.engine.convert import (
    plan_from_jax,
    result_to_numpy,
)
from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device


def _jax_plan(plan: JoinPlan):
    from hash_join_codes_knl_tpu.engine.config import JoinPlan as JaxPlan

    return JaxPlan(**dataclasses.asdict(plan))


def _compare(ik, iv, ok, ov, plan=None, jax_res=None):
    """Run both joins and assert agreement; returns the port's
    (result columns, plan)."""
    if jax_res is None:
        jax_res = jphj.join(ik, iv, ok, ov,
                            plan=None if plan is None else _jax_plan(plan))
    res_j, plan_j = jax_res
    res_t, plan_t = tphj.join(ik, iv, ok, ov, plan=plan, device="cpu")
    assert plan_t == plan_from_jax(plan_j)
    got = result_to_numpy(res_t)
    want = {f: np.asarray(getattr(res_j, f)).reshape(-1)
            for f in ("probe_keys", "probe_vals", "match_vals",
                      "match_cnts")}
    for f in ("probe_keys", "match_vals", "match_cnts"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    pairs = lambda d: np.sort(d["probe_keys"].astype(np.uint64) << 32
                              | d["probe_vals"])
    np.testing.assert_array_equal(pairs(got), pairs(want))
    np.testing.assert_array_equal(got["build_counts"],
                                  np.asarray(res_j.build_counts))
    assert int(res_t.join_tuples) % 2**32 == int(res_j.join_tuples)
    rows = join_oracle(ik, iv, ok, ov)
    assert int(res_t.join_tuples) == len(rows[0])
    if got["match_cnts"].max(initial=0) <= 1:
        digest = multiset_digest(*tphj.materialize(res_t))
        assert digest == multiset_digest(*jphj.materialize(res_j))
        assert digest == multiset_digest(*rows)
    return got, plan_t


def _generated(seed, ni, no, **kw):
    inner, outer, _ = generate(seed=seed, inner_tuples=ni, outer_tuples=no,
                               **kw)
    return inner.keys, inner.vals, outer.keys, outer.vals


def test_uniform_default_plan():
    _compare(*_generated(3, 4096, 65536, mode="uniform"))


@pytest.mark.parametrize("z", [0.75, 1.0])
def test_zipf(z):
    _compare(*_generated(5, 4096, 65536, mode="zipf", zipf=z))


def _mn_build(seed=7, ni=4096, no=32768, distinct=1500):
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 2**32, distinct, dtype=np.uint32)[
        rng.integers(0, distinct, ni)]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, ni, no - no // 4)],
                         rng.integers(1, 2**32, no // 4, dtype=np.uint32)])
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


def test_mn_build_duplicate_keys():
    got, _ = _compare(*_mn_build())
    assert got["match_cnts"].max() > 1


def _interpret_kernels(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode under its
    on-TPU resolution; returns the per-kernel call counts."""
    calls = {}
    for mod, name in ((jcl, "flat_to_rows"), (jmp, "merge_probe_pallas"),
                      (jmg, "merge_probe_gather"),
                      (jmg, "merge_probe_gather_indexed")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, interpret=True, **kw)

        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(jphj, "_on_tpu", lambda: True)
    return calls


def _chunked_plan():
    return dataclasses.replace(plan_join(4096, 65536, tile=512),
                               probe_chunks=8)


def test_chunked_plan_jnp_and_interpret_kernels(monkeypatch):
    """probe_chunks=8 puts K1's plain version on the port's path.  The
    JAX side runs twice: on its jnp path, and with its Pallas kernels in
    interpret mode under the on-TPU resolution."""
    ik, iv, ok, ov = _generated(9, 4096, 65536, mode="uniform")
    plan = _chunked_plan()
    _compare(ik, iv, ok, ov, plan)
    calls = _interpret_kernels(monkeypatch)
    jax.clear_caches()  # the jitted join must retrace under the kernels
    try:
        got, _ = _compare(ik, iv, ok, ov, plan)
    finally:
        jax.clear_caches()
    assert calls == {"flat_to_rows": 2, "merge_probe_pallas": 1}
    assert got["match_cnts"].sum() == 65536


def test_unique_build_over_duplicates_downgrades(monkeypatch):
    """unique_build=True over duplicate keys, in the gather band: the
    gather probe counts the violation and join() downgrades the plan.
    The JAX package counts it only in its gather kernel, so its side runs
    with the kernels in interpret mode (its jnp path never resolves to
    the gather kernel)."""
    ik, iv, ok, ov = _mn_build(seed=8, ni=2048, no=16384)
    plan = dataclasses.replace(plan_join(2048, 16384, tile=512),
                               window=1280, unique_build=True)
    calls = _interpret_kernels(monkeypatch)
    jax.clear_caches()
    try:
        _, final = _compare(ik, iv, ok, ov, plan)
    finally:
        jax.clear_caches()
    assert calls == {"merge_probe_gather": 2}  # first run, then downgraded
    assert not final.unique_build and final.gather_select == "flat"


def test_explicit_small_window_replans_like_jax():
    ik, iv, ok, ov = _generated(11, 4096, 65536, mode="uniform")
    plan = dataclasses.replace(plan_join(4096, 65536), window=128)
    _, final = _compare(ik, iv, ok, ov, plan)
    assert final.window > 128


def test_window_overflow_past_cap_shrinks_tile():
    """A chunked plan whose tiles span more than the gather cap: the
    re-planner shrinks the tile, identically in both packages."""
    ik, iv, ok, ov = _generated(12, 12288, 16384, mode="uniform")
    plan = dataclasses.replace(plan_join(12288, 16384, tile=4096),
                               probe_chunks=4)
    _, final = _compare(ik, iv, ok, ov, plan)
    assert final.tile < plan.tile


def _edge_relations():
    """Pads and tile edges: a probe side that is not a tile multiple,
    null keys (0) in the probe, the key whose scramble is 0xFFFFFFFF and
    the key 0xFFFFFFFF itself on both sides."""
    rng = np.random.default_rng(13)
    top = (-mod_inverse_u32(DEFAULT_FACTOR)) & 0xFFFFFFFF  # hk 0xFFFFFFFF
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2900]
    ik = np.concatenate([ik, [top, 0xFFFFFFFF, 1]]).astype(np.uint32)
    ik = np.unique(ik)
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    no = 3 * 2048 + 777
    ok = ik[rng.integers(0, len(ik), no)]
    ok[:40] = 0
    ok[40:90] = top
    ok[90:95] = 0xFFFFFFFF
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


@pytest.mark.parametrize("shape", ["edges", "tiny", "one_probe"])
def test_pad_and_tile_edges(shape):
    if shape == "edges":
        ik, iv, ok, ov = _edge_relations()
    else:
        rng = np.random.default_rng(14)
        ni, no = (5, 7) if shape == "tiny" else (300, 1)
        ik = rng.integers(1, 20, ni, dtype=np.uint32)
        ik = np.unique(ik)
        iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
        ok = rng.integers(1, 20, no, dtype=np.uint32)
        ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    _compare(ik, iv, ok, ov)


def test_forced_probe_impls_agree():
    """merge_pallas, merge_gather and merge_jnp return one result."""
    ik, iv, ok, ov = _generated(15, 4096, 32768, mode="uniform")
    base = dataclasses.replace(plan_join(4096, 32768), window=1280)
    outs = []
    for impl in ("merge_pallas", "merge_gather", "merge_jnp"):
        res, _ = tphj.join(ik, iv, ok, ov,
                           dataclasses.replace(base, probe_impl=impl),
                           device="cpu")
        outs.append(result_to_numpy(res))
    for o in outs[1:]:
        for f in ("probe_keys", "match_vals", "match_cnts", "build_counts"):
            np.testing.assert_array_equal(o[f], outs[0][f])


def test_join_accepts_tensors_and_refuses_bad_inputs():
    ik, iv, ok, ov = _generated(16, 1024, 8192, mode="uniform")
    cols = [u32_to_device(c, "cpu") for c in (ik, iv, ok, ov)]
    res, _ = tphj.join(*cols)
    assert int(res.join_tuples) == 8192
    # numpy columns without device= go to the card, and raise without one
    if torch.cuda.is_available():
        res, _ = tphj.join(ik, iv, ok, ov)
        assert res.match_cnts.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tphj.join(ik, iv, ok, ov)
    with pytest.raises(ValueError):
        tphj.join(cols[0].to(torch.int64), *cols[1:])
    # a two-class plan runs; its wide window must fit the build side
    with pytest.raises(ValueError, match="wider than the build side"):
        tphj.join(*cols, dataclasses.replace(plan_join(1024, 8192),
                                             window=1280, window_wide=4096))


# ---- the two-class window geometry ----------------------------------------


def _mk_skewish(seed=131, ni=4096, no=65536):
    """tests/test_phj.py's two-class workload: tile spans straddle the
    narrow window, so both classes are populated."""
    rng = np.random.default_rng(seed)
    ik = np.unique(rng.integers(1, 2**32, ni + 800, dtype=np.uint32))[:ni]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = ik[rng.integers(0, ni, no)].astype(np.uint32)
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


def _two_class_plan(window=384, window_wide=1920, wide_cap=128, **kw):
    return dataclasses.replace(plan_join(4096, 65536, tile=512),
                               probe_chunks=8, window=window,
                               window_wide=window_wide, wide_cap=wide_cap,
                               **kw)


def test_two_class_matches_jax_kernels(monkeypatch):
    """The port's two passes (the narrow dense probe, then K4 over the
    wide tiles; plain versions here) against the JAX package's Pallas
    kernels in interpret mode under its on-TPU resolution."""
    cols = _mk_skewish()
    plan = _two_class_plan()
    calls = _interpret_kernels(monkeypatch)
    jax.clear_caches()
    try:
        got, final = _compare(*cols, plan)
    finally:
        jax.clear_caches()
    assert calls == {"flat_to_rows": 2, "merge_probe_pallas": 1,
                     "merge_probe_gather_indexed": 1}
    assert final == plan  # no re-plan: both classes fit
    # the wide class is populated, and the narrow window alone misses
    t = {f: u32_to_device(c, "cpu") for f, c in zip("abcd", cols)}
    tile, window, rows, cap = tphj._merge_params(plan, 4096, 65536)
    bhk, _ = tphj._merge_sort_side(t["a"], t["b"], rows * 128, plan.factor)
    ohk, _ = tphj._merge_sort_probe(t["c"], t["d"], cap, 8, plan.factor)
    _, stats, (tidx, _, wide_ovf) = tphj._merge_windows(
        bhk, ohk, tile, window, rows, plan.window_wide, plan.wide_cap)
    _, narrow = tphj._merge_windows(bhk, ohk, tile, window, rows)
    assert int(wide_ovf) == 0 and int(stats[0]) == 0
    assert int(narrow[0]) > 4 and len(np.unique(tidx.numpy())) == 128


def test_two_class_matches_jax_jnp_path():
    """merge_jnp: one plain pass at the wide width in both packages."""
    got, final = _compare(*_mk_skewish(seed=133),
                          _two_class_plan(probe_impl="merge_jnp"))
    assert final.window_wide == 1920


def test_two_class_windows_match_jax():
    """_merge_windows' two-class values, including the class order of the
    tile list and a list longer than the tile count."""
    ik, iv, ok, ov = _mk_skewish(seed=135)
    plan = _two_class_plan()
    tile, window, rows, cap = tphj._merge_params(plan, 4096, 65536)
    bhk, _ = tphj._merge_sort_side(u32_to_device(ik, "cpu"),
                                   u32_to_device(iv, "cpu"), rows * 128,
                                   plan.factor)
    ohk, _ = tphj._merge_sort_probe(u32_to_device(ok, "cpu"),
                                    u32_to_device(ov, "cpu"), cap, 8,
                                    plan.factor)
    bhk_j = (bhk ^ tphj.BIAS).numpy().view(np.uint32)
    ohk_j = (ohk ^ tphj.BIAS).numpy().view(np.uint32).reshape(8, -1)
    for wide_cap in (16, 128, 1000):  # 128 tiles: 1000 takes them all
        got = tphj._merge_windows(bhk, ohk, tile, window, rows, 1920,
                                  wide_cap)
        want = jphj._merge_windows(jax.numpy.asarray(bhk_j),
                                   jax.numpy.asarray(ohk_j), tile, window,
                                   rows, window_wide=1920,
                                   wide_cap=wide_cap)
        for g, w in ((got[0], want[0]), (got[1], want[1]),
                     *zip(got[2], want[2])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(got[2][0]) == cap // tile


def test_two_class_wide_cap_downgrade_like_jax():
    """More wide tiles than wide_cap: both packages downgrade to one
    class at window_wide (tests/test_phj.py's expectation)."""
    _, final = _compare(*_mk_skewish(seed=137), _two_class_plan(wide_cap=2))
    assert final.window_wide == 0 and final.window == 1920


@pytest.mark.parametrize("kw,match", [
    (dict(window=0), "explicit narrow"),
    (dict(window=1920, window_wide=1920), "explicit narrow"),
    (dict(window_wide=40_000), "gather"),
])
def test_two_class_plan_refusals_like_jax(kw, match):
    plan = _two_class_plan(**kw)
    with pytest.raises(ValueError, match=match):
        jphj._merge_params(_jax_plan(plan), 4096, 65536)
    with pytest.raises(ValueError, match=match):
        tphj._merge_params(plan, 4096, 65536)


def test_two_class_wide_past_build_side_refused_like_jax(monkeypatch):
    """A build side narrower than the wide window: the JAX package's
    window slice cannot exceed the build side, on its jnp path and on its
    kernels, so it refuses; the port refuses too."""
    rng = np.random.default_rng(139)
    ik = np.unique(rng.integers(1, 2**32, 300, dtype=np.uint32))[:200]
    iv = rng.integers(0, 2**32, 200, dtype=np.uint32)
    ok = ik[rng.integers(0, 200, 4096)]
    plan = dataclasses.replace(plan_join(200, 4096, tile=512), window=384,
                               window_wide=1920, wide_cap=8)
    assert tphj._merge_params(plan, 200, 4096)[2] * 128 < 1920
    with pytest.raises(TypeError, match="slice"):
        jphj.join(ik, iv, ok, ok, plan=_jax_plan(plan))
    _interpret_kernels(monkeypatch)
    jax.clear_caches()
    try:
        with pytest.raises(TypeError, match="slice"):
            jphj.join(ik, iv, ok, ok, plan=_jax_plan(plan))
    finally:
        jax.clear_caches()
    with pytest.raises(ValueError, match="wider than the build side"):
        tphj.join(ik, iv, ok, ok, plan, device="cpu")


def test_materialize_refuses_multi_match():
    res, _ = tphj.join(*_mn_build(), device="cpu")
    with pytest.raises(ValueError, match="multi-match"):
        tphj.materialize(res)


def test_default_plan_matches_jax_plan():
    assert plan_join(4096, 65536) == plan_from_jax(jax_plan_join(4096, 65536))


# ---- the padded and radix modes ----------------------------------------


def _padded_relations(seed, ni, no):
    """Unique build keys; probes 3/4 hits, the rest random, some null."""
    rng = np.random.default_rng(seed)
    ik = np.unique(rng.integers(1, 2**32, 2 * ni, dtype=np.uint32))[:ni]
    ik = ik[rng.permutation(ni)]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, ni, no - no // 4)],
                         rng.integers(1, 2**32, no // 4, dtype=np.uint32)])
    ok[rng.integers(0, no, no // 50)] = 0
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


def _padded_pair(cols, plan):
    """JAX join with probe_impl="jnp" and the port's join with `plan`;
    checks the plan conversion and the oracle digest, returns both
    results as numpy columns."""
    res_j, plan_j = jphj.join(*cols, plan=_jax_plan(
        dataclasses.replace(plan, probe_impl="jnp")))
    res_t, plan_t = tphj.join(*cols, plan=plan, device="cpu")
    assert plan_t == plan
    assert plan_from_jax(plan_j) == dataclasses.replace(plan,
                                                        probe_impl="jnp")
    want = {f: np.asarray(getattr(res_j, f)).reshape(-1)
            for f in ("probe_keys", "probe_vals", "match_vals",
                      "match_cnts", "build_counts")}
    digest = multiset_digest(*tphj.materialize(res_t))
    assert digest == multiset_digest(*jphj.materialize(res_j))
    assert digest == multiset_digest(*join_oracle(*cols))
    return result_to_numpy(res_t), want


@pytest.mark.parametrize("impl", ["sort", "argsort"])
@pytest.mark.parametrize("probe_impl", ["pallas", "auto", "jnp"])
def test_padded_sort_modes_slot_for_slot(impl, probe_impl):
    """Both layouts sort stably, so every column agrees slot for slot,
    probe values included, and so do the build partition counts."""
    cols = _padded_relations(31, 2048, 8192)
    plans = [
        JoinPlan(p_bits=4, slots=512, tile=256, pass_bits=(4,),
                 partition_impl=impl, probe_impl=probe_impl),
        JoinPlan(p_bits=3, slots=1024, tile=384, pass_bits=(3,),
                 skip_bits=3, partition_impl=impl, probe_impl=probe_impl),
        dataclasses.replace(plan_join(2048, 8192), partition_impl=impl,
                            probe_impl=probe_impl),
    ]
    for plan in plans:
        got, want = _padded_pair(cols, plan)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert got["build_counts"].shape == (plan.num_partitions,)
        assert got["match_cnts"].sum() == len(join_oracle(*cols)[0])


@pytest.mark.parametrize("pass_bits", [(6,), (3, 3)])
def test_padded_radix_mode(pass_bits):
    """Radix runs keep input order within a run where the JAX kernel
    sorts each run, so the results agree in build_counts (pass overflow
    last), in the materialized digest and in the match-count sums."""
    cols = _padded_relations(29, 2048, 2048)
    plan = JoinPlan(p_bits=6, slots=1024, tile=2048, pass_bits=pass_bits,
                    partition_impl="radix", probe_impl="pallas")
    got, want = _padded_pair(cols, plan)
    np.testing.assert_array_equal(got["build_counts"], want["build_counts"])
    assert got["build_counts"].shape == (65,) and got["build_counts"][-1] == 0
    assert got["match_cnts"].sum() == want["match_cnts"].sum() > 0
    assert got["probe_keys"].shape == want["probe_keys"].shape


def test_padded_overflows_raise():
    """A build partition past plan.slots, and a radix run past its
    region: both packages refuse the result."""
    ik, iv, ok, ov = _padded_relations(33, 2048, 4096)
    tight = JoinPlan(p_bits=2, slots=64, tile=256, probe_impl="jnp")
    same = np.full(2048, 0x12345, np.uint32)
    radix = JoinPlan(p_bits=3, slots=64, tile=128, pass_bits=(3,),
                     partition_impl="radix", probe_impl="jnp")
    for cols, plan in (((ik, iv, ok, ov), tight),
                       ((same, iv, ok, ov), radix)):
        with pytest.raises(RuntimeError, match="overflow"):
            jphj.join(*cols, plan=_jax_plan(plan))
        with pytest.raises(RuntimeError, match="overflow"):
            tphj.join(*cols, plan=plan, device="cpu")
    res = tphj.phj_join(*(u32_to_device(c, "cpu") for c in
                          (same, iv, ok, ov)), radix)
    assert int(res.build_counts[-1]) > 0  # the overflow is a value
    assert int(res.build_counts[:-1].sum()) == 2048  # counts stay exact


def test_radix_plan_needs_pass_bits_summing_to_p_bits():
    cols = [u32_to_device(c, "cpu") for c in _padded_relations(34, 256, 512)]
    with pytest.raises(ValueError, match="pass_bits"):
        tphj.phj_join(*cols, JoinPlan(p_bits=6, slots=64, tile=128,
                                      pass_bits=(3,),
                                      partition_impl="radix",
                                      probe_impl="auto"))
