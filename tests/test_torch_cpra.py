"""The port's CPRA (parallel/cpra.py) against the JAX package's on the
same numpy inputs: W thread ranks with gloo on the CPU against W of the
8 virtual CPU devices.

Per shard (rank r against device r's block of the sharded result):
probe keys, match values, match counts and build_counts slot for slot;
probe values as a multiset (the JAX probe sort is unstable).  The packs
slot for slot (sort) and by counts, overflow and per-run multisets
(radix: the JAX pass sorts each tile, the port's keeps input order).
Then the paths of tests/test_cpra*.py and test_tier_ratio.py: overflow
detection and the retries, the window re-plan from the measured span,
skew, tier routing, the staged, pipelined and two-level steps, odd
sizes, bad knobs, the one-rank shortcut."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from hash_join_codes_knl_tpu.engine.config import JoinPlan as JaxPlan
from hash_join_codes_knl_tpu.parallel import cpra as jcpra
from hash_join_codes_knl_tpu.relgen.generate import generate
from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan
from hash_join_codes_knl_tpu_torch.engine.oracle import (
    join_oracle,
    multiset_digest,
)
from hash_join_codes_knl_tpu_torch.engine.phj import JoinResult
from hash_join_codes_knl_tpu_torch.parallel import cpra as tcpra
from hash_join_codes_knl_tpu_torch.parallel.distributed import (
    run_ranks,
    shard_null_padded,
    split_2level,
    thread_meshes,
)
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    to_numpy_u32,
    u32_to_device,
)

FIELDS = ("probe_keys", "match_vals", "match_cnts", "build_counts")
# tests/test_cpra.py:41-49's relations
CASES = {
    "ref": dict(inner_tuples=4096, outer_tuples=4096, mode="ref"),
    "uniform": dict(inner_tuples=2048, outer_tuples=32768, mode="uniform"),
    "zipf": dict(inner_tuples=2048, outer_tuples=32768, mode="zipf",
                 zipf=0.75),
    "selc": dict(inner_tuples=4096, outer_tuples=32768, mode="uniform",
                 selc=0.5),
}
PLAN = dict(p_bits=6, slots=256, tile=256, pass_bits=(6,))


def _np(t):
    return to_numpy_u32(t) if t.dtype == torch.int32 and t.dim() else \
        t.numpy()


def _jcol(a, field):
    a = np.asarray(a)
    return a.astype(np.int64) if field in ("match_cnts", "build_counts") \
        else a.astype(np.uint32).astype(np.int64)


def _ranks(W, fn):
    return run_ranks(thread_meshes(W, "cpu", timeout_s=120), fn,
                     timeout_s=300)


def _assert_shards(jres, tres, W):
    """Port rank r's result equals the JAX result's device-r block."""
    for f in FIELDS:
        blocks = _jcol(getattr(jres, f), f).reshape(W, -1)
        for r, t in enumerate(tres):
            got = getattr(t, f).numpy().astype(np.int64)
            if f not in ("match_cnts", "build_counts"):
                got &= 0xFFFFFFFF
            np.testing.assert_array_equal(got, blocks[r], err_msg=f"{f} {r}")
    pv = np.asarray(jres.probe_vals).reshape(W, -1)
    for r, t in enumerate(tres):
        assert np.array_equal(np.sort(to_numpy_u32(t.probe_vals)),
                              np.sort(pv[r]))


def _digest(results):
    cols = [[], [], []]
    for res in results:
        m = res.match_cnts.numpy() == 1
        for c, t in zip(cols, (res.probe_keys, res.probe_vals,
                               res.match_vals)):
            c.append(to_numpy_u32(t)[m])
    return multiset_digest(*(np.concatenate(c) for c in cols))


def _total(results):
    return sum(int(r.join_tuples) for r in results)


@pytest.fixture(scope="module")
def relations():
    return {name: generate(seed=31, prefer_native=False, **kw)[:2]
            for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def jax_results(relations):
    """The JAX cpra_join of every case at 2 and 4 devices, computed once."""
    out = {}
    for W in (2, 4):
        mesh = jax.make_mesh((W,), ("x",), devices=jax.devices()[:W])
        for name, (inner, outer) in relations.items():
            out[W, name] = jcpra.cpra_join(
                inner.keys, inner.vals, outer.keys, outer.vals, mesh,
                JaxPlan(**PLAN), slack=4.0)[0]
    return out


def test_pack_by_owner_like_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 2**32, 1000, dtype=np.uint32)
    keys[::50] = 0
    vals = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    owner = rng.integers(0, 4, 1000).astype(np.int32)
    owner[keys == 0] = 4  # nulls route out of range and are dropped
    for cap in (512, 200):  # roomy, and overflowing
        want = jcpra.pack_by_owner(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(owner), 4, cap)
        got = tcpra.pack_by_owner(u32_to_device(keys, "cpu"),
                                  u32_to_device(vals, "cpu"),
                                  torch.from_numpy(owner), 4, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert (np.asarray(want[2]) > 200).any()


@pytest.mark.parametrize("cap", [0, 1024, 128])
def test_radix_pack_like_jax(cap):
    """Counts and overflow equal; each run (partition region) equal as a
    (key, value) multiset."""
    rng = np.random.default_rng(1)
    keys = rng.integers(1, 2**32, 6000, dtype=np.uint32)
    keys[::97] = 0
    vals = rng.integers(0, 2**32, 6000, dtype=np.uint32)
    factor, c_bits = 0x9E3779B1, 2
    wk, wv, wc, wo = jcpra.pack_by_owner_radix(
        jnp.asarray(keys), jnp.asarray(vals), factor, c_bits, cap=cap,
        interpret=True)
    gk, gv, gc, go = tcpra.pack_by_owner_radix(
        u32_to_device(keys, "cpu"), u32_to_device(vals, "cpu"), factor,
        c_bits, cap=cap)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert int(go) == int(wo)
    assert gk.shape[0] == np.asarray(wk).shape[0]
    if int(go):
        return  # an overflowed pass's regions are partial in both
    C = 1 << c_bits
    for p, (a, b, c, d) in enumerate(zip(
            np.split(_np(gk), C), np.split(_np(gv), C),
            np.split(np.asarray(wk), C), np.split(np.asarray(wv), C))):
        live, jlive = a != 0, c != 0
        assert sorted(zip(a[live], b[live])) == sorted(zip(c[jlive],
                                                           d[jlive])), p


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_cpra_join_per_shard_like_jax(relations, jax_results, W, name):
    inner, outer = relations[name]
    out = _ranks(W, lambda m: tcpra.cpra_join(
        inner.keys, inner.vals, outer.keys, outer.vals, m,
        JoinPlan(**PLAN), slack=4.0))
    res = [o[0] for o in out]
    _assert_shards(jax_results[W, name], res, W)
    want = join_oracle(inner.keys, inner.vals, outer.keys, outer.vals)
    assert _total(res) == len(want[0])
    if name != "selc":  # unique build keys: the digest holds
        assert _digest(res) == multiset_digest(*want)


def test_overflow_detection():
    # all keys identical: one owner gets everything, tiny caps blow
    keys = np.full(4096, 12345, dtype=np.uint32)
    plan = JoinPlan(p_bits=4, slots=64, tile=128, pass_bits=(4,))

    def body(m):
        with pytest.raises(RuntimeError, match="overflow"):
            tcpra.cpra_join(keys, keys, keys, keys, m, plan, slack=1.0)
        return True

    assert all(_ranks(4, body))


def _hot_workload(seed, n_probe, hot_frac_or_count):
    rng = np.random.default_rng(seed)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = ik * np.uint32(3)
    hot = ik[7]
    ok = ik[rng.integers(0, 2048, n_probe)].astype(np.uint32)
    if isinstance(hot_frac_or_count, float):
        ok = np.where(rng.random(n_probe) < hot_frac_or_count, hot,
                      ok).astype(np.uint32)
    else:
        ok[rng.integers(0, n_probe, hot_frac_or_count)] = hot
    return ik, iv, ok, ok * np.uint32(5), hot


def test_overflow_auto_retry_like_jax():
    """~25% of probes on one key overflow slack 1.0; the retries with
    doubled slack fit it, to the JAX package's result."""
    ik, iv, ok, ov, _ = _hot_workload(23, 8192, 2048)
    jplan = JaxPlan(p_bits=4, slots=128, tile=128, pass_bits=(4,))
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4])
    jres, _ = jcpra.cpra_join(ik, iv, ok, ov, mesh, jplan, slack=1.0,
                              retries=3)
    out = _ranks(4, lambda m: tcpra.cpra_join(
        ik, iv, ok, ov, m, JoinPlan(**dataclasses.asdict(jplan)),
        slack=1.0, retries=3))
    _assert_shards(jres, [o[0] for o in out], 4)
    assert _digest([o[0] for o in out]) == multiset_digest(
        *join_oracle(ik, iv, ok, ov))


def test_window_replan_from_measured_span_like_jax():
    """A build key duplicated 3000 times makes the span exceed the auto
    window; the re-planner sizes the next window from the measured span
    in the step's diag, to the JAX package's final plan."""
    rng = np.random.default_rng(97)
    ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
    hot = ik[123]
    ik_dup = np.concatenate([ik, np.full(3000, hot, np.uint32)])
    iv = rng.integers(0, 2**32, len(ik_dup), dtype=np.uint32)
    ok = ik[rng.integers(0, 4096, 32768)].astype(np.uint32)
    ok[::64] = hot
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    jplan = JaxPlan(p_bits=4, slots=1024, tile=256, pass_bits=(4,),
                    probe_chunks=4)
    mesh = jax.make_mesh((2,), ("x",), devices=jax.devices()[:2])
    jres, jfinal = jcpra.cpra_join(ik_dup, iv, ok, ov, mesh, jplan,
                                   slack=4.0, retries=1)
    out = _ranks(2, lambda m: tcpra.cpra_join(
        ik_dup, iv, ok, ov, m, JoinPlan(**dataclasses.asdict(jplan)),
        slack=4.0, retries=1))
    assert all(o[1] == JoinPlan(**dataclasses.asdict(jfinal)) for o in out)
    assert out[0][1].window >= 3000
    _assert_shards(jres, [o[0] for o in out], 2)
    assert _total([o[0] for o in out]) == len(
        join_oracle(ik_dup, iv, ok, ov)[0])


def test_skew_heavy_hitter_replication_like_jax():
    """One key on ~30% of the probes: the exchange overflows slack 1.5
    without skew handling; with replication the light and heavy rows
    equal the JAX package's, shard by shard, and the oracle together."""
    ik, iv, ok, ov, hot = _hot_workload(11, 32768, 0.30)
    jplan = JaxPlan(p_bits=6, slots=128, tile=256, pass_bits=(6,))
    plan = JoinPlan(**dataclasses.asdict(jplan))
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4])
    jres, jheavy, _ = jcpra.cpra_join(ik, iv, ok, ov, mesh, jplan,
                                      slack=1.5, skew=True,
                                      heavy_frac=1 / 64)

    def body(m):
        with pytest.raises(RuntimeError, match="overflow"):
            tcpra.cpra_join(ik, iv, ok, ov, m, plan, slack=1.5, retries=0)
        return tcpra.cpra_join(ik, iv, ok, ov, m, plan, slack=1.5,
                               skew=True, heavy_frac=1 / 64)

    out = _ranks(4, body)
    _assert_shards(jres, [o[0] for o in out], 4)
    for k, name in enumerate(("probe_keys", "probe_vals", "match_vals",
                              "match_cnts")):
        want = np.asarray(jheavy[k]).reshape(4, -1).astype(np.int64)
        for r, o in enumerate(out):
            got = o[1][k].numpy().astype(np.int64)
            if name != "match_cnts":
                got &= 0xFFFFFFFF
            np.testing.assert_array_equal(got, want[r], err_msg=name)
    light = [o[0] for o in out]
    keys, vals, tabs = [], [], []
    for res, (hk, hv, ht, hc) in [(o[0], o[1]) for o in out]:
        for c, t, mc in ((keys, res.probe_keys, res.match_cnts),
                         (vals, res.probe_vals, res.match_cnts),
                         (tabs, res.match_vals, res.match_cnts)):
            c.append(to_numpy_u32(t)[mc.numpy() == 1])
        m = hc.numpy() == 1
        keys.append(to_numpy_u32(hk)[m])
        vals.append(to_numpy_u32(hv)[m])
        tabs.append(to_numpy_u32(ht)[m])
    got = multiset_digest(*(np.concatenate(c) for c in (keys, vals, tabs)))
    assert got == multiset_digest(*join_oracle(ik, iv, ok, ov))
    heavy_hot = sum(int(((to_numpy_u32(o[1][0]) == hot)
                         & (o[1][3].numpy() == 1)).sum()) for o in out)
    assert heavy_hot == int((ok == hot).sum())
    assert _total(light) + sum(int(o[1][3].sum()) for o in out) == len(ok)


@pytest.mark.parametrize("ratio", [0.5, 0.75])
def test_tier_routing_like_jax(ratio):
    inner, outer, _ = generate(seed=19, inner_tuples=1024,
                               outer_tuples=16384, mode="uniform",
                               prefer_native=False)
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4])
    jres, jplan = jcpra.cpra_join(inner.keys, inner.vals, outer.keys,
                                  outer.vals, mesh, slack=4.0,
                                  tier_ratio=ratio)
    out = _ranks(4, lambda m: tcpra.cpra_join(
        inner.keys, inner.vals, outer.keys, outer.vals, m, slack=4.0,
        tier_ratio=ratio))
    assert out[0][1] == JoinPlan(**dataclasses.asdict(jplan))
    _assert_shards(jres, [o[0] for o in out], 4)
    assert _digest([o[0] for o in out]) == multiset_digest(*join_oracle(
        inner.keys, inner.vals, outer.keys, outer.vals))


def _jax_args(mesh, *cols, spec=P("x")):
    sh = NamedSharding(mesh, spec)
    return [jax.device_put(np.asarray(c), sh) for c in cols]


def _rank_args(m, *cols):
    return [shard_null_padded(c, m) for c in cols]


def test_radix_pack_step_like_jax():
    """pack_impl='radix': the step's result equals the JAX radix step's
    and the sort-pack step's, per shard; a tight outer_cap is exchange
    overflow (diag[0]), never a silent drop."""
    inner, outer, _ = generate(seed=73, inner_tuples=2048,
                               outer_tuples=8192, mode="uniform",
                               prefer_native=False)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    jplan = JaxPlan(p_bits=4, slots=256, tile=128, pass_bits=(4,))
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4])
    jargs = _jax_args(mesh, *cols)
    jres, _, jdiag = jcpra.make_cpra_step(mesh, jplan, 2048, 8192,
                                          pack_impl="radix")(*jargs)
    jsort = jcpra.make_cpra_step(mesh, jplan, 2048, 8192)(*jargs)[0]
    plan = JoinPlan(**dataclasses.asdict(jplan))

    def body(m):
        args = _rank_args(m, *cols)
        radix = tcpra.make_cpra_step(m, plan, 2048, 8192,
                                     pack_impl="radix")(*args)
        sort = tcpra.make_cpra_step(m, plan, 2048, 8192)(*args)
        tight = tcpra.make_cpra_step(m, plan, 2048, 128,
                                     pack_impl="radix")(*args)
        return radix, sort, tight[2]

    out = _ranks(4, body)
    assert out[0][0][2].tolist() == np.asarray(jdiag).tolist()
    assert out[0][0][2][:2].tolist() == [0, 0]
    _assert_shards(jres, [o[0][0] for o in out], 4)
    _assert_shards(jsort, [o[1][0] for o in out], 4)
    want = multiset_digest(*join_oracle(*cols))
    assert _digest([o[0][0] for o in out]) == want
    assert _digest([o[1][0] for o in out]) == want
    assert int(out[0][2][0]) > 0


def test_staged_steps_like_jax():
    """The staged exchange and local join equal make_cpra_step's result,
    and the JAX staged steps', per shard; overflow flags agree."""
    inner, outer, _ = generate(seed=29, inner_tuples=2048,
                               outer_tuples=16384, mode="uniform",
                               prefer_native=False)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    jplan = JaxPlan(**PLAN)
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4])
    ex, jo = jcpra.make_cpra_steps_staged(mesh, jplan, 512, 4096)
    *xch, jeovf = ex(*_jax_args(mesh, *cols))
    jres, jjovf = jo(*xch)
    plan = JoinPlan(**PLAN)

    def body(m):
        tex, tjo = tcpra.make_cpra_steps_staged(m, plan, 512, 4096)
        *got, eovf = tex(*_rank_args(m, *cols))
        res, jovf = tjo(*got)
        return res, eovf, jovf

    out = _ranks(4, body)
    assert all(o[1] == bool(jeovf) and o[2] == bool(jjovf) for o in out)
    _assert_shards(jres, [o[0] for o in out], 4)


def test_pipelined_like_jax():
    W, chunks = 4, 4
    inner, outer, _ = generate(seed=47, inner_tuples=2048,
                               outer_tuples=32768, mode="uniform",
                               prefer_native=False)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    jplan = JaxPlan(p_bits=5, slots=128, tile=256, pass_bits=(5,))
    icap, ocap = 4 * 2048 // (W * W), 4 * 32768 // (W * W)
    mesh = jax.make_mesh((W,), ("x",), devices=jax.devices()[:W])
    jres, jovf = jcpra.make_cpra_step_pipelined(mesh, jplan, icap, ocap,
                                                chunks)(
        *_jax_args(mesh, *cols))
    assert not bool(jovf)
    plan = JoinPlan(**dataclasses.asdict(jplan))
    out = _ranks(W, lambda m: tcpra.make_cpra_step_pipelined(
        m, plan, icap, ocap, chunks)(*_rank_args(m, *cols)))
    assert not any(o[1] for o in out)
    _assert_shards(jres, [o[0] for o in out], W)
    assert _digest([o[0] for o in out]) == multiset_digest(*join_oracle(
        *cols))


def test_two_level_like_jax():
    H, C = 2, 2
    inner, outer, _ = generate(seed=59, inner_tuples=2048,
                               outer_tuples=16384, mode="uniform",
                               prefer_native=False)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    jplan = JaxPlan(p_bits=4, slots=128, tile=128, pass_bits=(4,))
    mesh = jax.make_mesh((H, C), ("h", "c"), devices=jax.devices()[:H * C])
    jres, jovf = jcpra.make_cpra_step_2level(mesh, jplan, 2048, 8192)(
        *_jax_args(mesh, *cols, spec=P(("h", "c"))))
    assert not bool(jovf)
    plan = JoinPlan(**dataclasses.asdict(jplan))
    # slots=1: occupancy overflow on every padded partition
    padded = JoinPlan(p_bits=2, slots=1, tile=128, pass_bits=(2,),
                      probe_impl="jnp")

    def body(m):
        h, c = split_2level(m, H)
        args = _rank_args(m, *cols)
        res = tcpra.make_cpra_step_2level(h, c, plan, 2048, 8192)(*args)
        bad = tcpra.make_cpra_step_2level(h, c, padded, 2048, 16384)(*args)
        return res, bad[1]

    out = _ranks(H * C, body)
    assert not any(o[0][1] for o in out) and all(o[1] for o in out)
    res = [o[0][0] for o in out]
    _assert_shards(jres, res, H * C)
    assert _digest(res) == multiset_digest(*join_oracle(*cols))
    seen = set()  # each key owned by one rank
    for r in res:
        ks = set(to_numpy_u32(r.probe_keys)[r.match_cnts.numpy() == 1]
                 .tolist())
        assert not (seen & ks)
        seen |= ks


def test_odd_relation_sizes():
    """Lengths that do not divide the mesh shard by null padding."""
    rng = np.random.default_rng(41)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:1255]
    iv = rng.integers(0, 2**32, 1255, dtype=np.uint32)
    ok = ik[rng.integers(0, 1255, 9377)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 9377, dtype=np.uint32)
    out = _ranks(4, lambda m: tcpra.cpra_join(ik, iv, ok, ov, m, slack=4.0))
    assert _total([o[0] for o in out]) == len(join_oracle(ik, iv, ok, ov)[0])


def test_rejects_bad_knobs():
    plan = JoinPlan(p_bits=4, slots=128, tile=128, pass_bits=(4,))
    padded = dataclasses.replace(plan, probe_impl="pallas")

    def body(m):
        with pytest.raises(ValueError, match="pack_impl"):
            tcpra.make_cpra_step(m, plan, 128, 128, pack_impl="radx")
        with pytest.raises(ValueError, match="merge"):
            tcpra.make_cpra_step(m, padded, 128, 128, tier_ratio=0.5)
        with pytest.raises(ValueError, match="incompatible"):
            tcpra.make_cpra_step(m, plan, 128, 128, tier_ratio=0.5,
                                 pack_impl="radix")
        return True

    assert all(_ranks(2, body))
    with pytest.raises(ValueError, match="power of two"):
        tcpra._owner_bits(3)


def test_one_rank_shortcut_like_jax():
    """A one-rank mesh without skew is the single-device join(): the JAX
    package's one-device result slot for slot (probe values by multiset)."""
    inner, outer, _ = generate(seed=61, inner_tuples=1024,
                               outer_tuples=8192, mode="uniform",
                               prefer_native=False)
    jplan = JaxPlan(p_bits=5, slots=128, tile=128, pass_bits=(5,))
    mesh = jax.make_mesh((1,), ("x",), devices=jax.devices()[:1])
    jres, _ = jcpra.cpra_join(inner.keys, inner.vals, outer.keys,
                              outer.vals, mesh, jplan, slack=4.0)
    res, _ = tcpra.cpra_join(inner.keys, inner.vals, outer.keys, outer.vals,
                             thread_meshes(1, "cpu")[0],
                             JoinPlan(**dataclasses.asdict(jplan)),
                             slack=4.0)
    _assert_shards(jres, [res], 1)


def test_one_rank_padded_overflow_raises():
    inner, outer, _ = generate(seed=67, inner_tuples=1024,
                               outer_tuples=4096, mode="uniform",
                               prefer_native=False)
    plan = JoinPlan(p_bits=2, slots=128, tile=128, pass_bits=(2,),
                    probe_impl="jnp")
    with pytest.raises(RuntimeError, match="slots"):
        tcpra.cpra_join(inner.keys, inner.vals, outer.keys, outer.vals,
                        thread_meshes(1, "cpu")[0], plan, slack=4.0)


def test_padded_local_overflow_raises_over_ranks():
    """A padded local plan's overflow cannot be re-planned: it raises on
    every rank."""
    inner, outer, _ = generate(seed=67, inner_tuples=2048,
                               outer_tuples=4096, mode="uniform",
                               prefer_native=False)
    plan = JoinPlan(p_bits=2, slots=16, tile=128, pass_bits=(2,),
                    probe_impl="jnp")

    def body(m):
        with pytest.raises(RuntimeError, match="slots"):
            tcpra.cpra_join(inner.keys, inner.vals, outer.keys, outer.vals,
                            m, plan, slack=4.0)
        return True

    assert all(_ranks(2, body))


def test_padded_radix_local_plan():
    """A padded radix local plan (the tile probe's path) over ranks: the
    oracle's digest, engine overflow 0 in the diag."""
    inner, outer, _ = generate(seed=83, inner_tuples=2048,
                               outer_tuples=16384, mode="uniform",
                               prefer_native=False)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    plan = JoinPlan(p_bits=4, slots=256, tile=128, pass_bits=(4,),
                    partition_impl="radix", probe_impl="pallas")
    out = _ranks(4, lambda m: tcpra.cpra_join(*cols, m, plan, slack=4.0))
    assert _digest([o[0] for o in out]) == multiset_digest(*join_oracle(
        *cols))


def test_engine_overflow_accessors():
    z = torch.zeros(4, dtype=torch.int32)
    merge = JoinPlan(p_bits=4, slots=64, tile=128, probe_impl="merge")
    res = JoinResult(z, z, z, z, torch.tensor([0, 512, 3]))
    assert int(tcpra._engine_overflow(res, merge)) == 3
    assert int(tcpra._engine_span(res, merge)) == 512
    assert int(tcpra._engine_select_overflow(res, merge)) == 3
    res2 = JoinResult(z, z, z, z, torch.tensor([2, 900, 0]))
    assert int(tcpra._engine_overflow(res2, merge)) == 2
    assert int(tcpra._engine_select_overflow(res2, merge)) == 0
    radix = JoinPlan(p_bits=2, slots=64, tile=128, pass_bits=(2,),
                     partition_impl="radix", probe_impl="pallas")
    res3 = JoinResult(z, z, z, z, torch.tensor([70, 1, 2, 3, 5]))
    assert int(tcpra._engine_overflow(res3, radix)) == 5
    assert int(tcpra._engine_span(res3, radix)) == 0
    sort = dataclasses.replace(radix, partition_impl="sort")
    assert int(tcpra._engine_overflow(res3, sort)) == 1
