"""The randomized differential campaigns of tests/test_fuzz.py, through
the port on the CPU: the same seeds, the same random workloads and random
plans (tests/torch_fuzz_cases.py), each held against the JAX package's
join_oracle and multiset_digest: cardinality, and the row digest (M:N
rows expanded).  The merge, NPJ, CPRA, columns and aggregate campaigns
are also held against the JAX package on the same draw: the merge join's
final plan, probe keys, match values, match counts and build counts slot
for slot and its probe values as a multiset (the JAX probe sort is
unstable); NPJ's counts and match values slot for slot in input order,
its keys, match values and counts in sorted order; CPRA's per-shard join
sums; the column joins' columns, dtypes and rows in every mode; the
aggregates' group counts, keys, sums, counts and overflow slot for
slot."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hash_join_codes_knl_tpu.engine.columns as jcols
import hash_join_codes_knl_tpu.engine.npj as jnpj
import hash_join_codes_knl_tpu.engine.phj as jphj
import hash_join_codes_knl_tpu.ops.aggregate as jagg
import torch_fuzz_cases as fz
from hash_join_codes_knl_tpu.engine.config import JoinPlan as JaxPlan
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.parallel.cpra import cpra_join as jax_cpra_join
from hash_join_codes_knl_tpu_torch.engine.convert import plan_from_jax


def _checked(campaign, seed, tmp_path):
    """The draw through the port on the CPU, held against the JAX
    package's oracle; returns (draw, outputs)."""
    d = fz.draw(campaign, seed)
    if d.get("skip"):
        pytest.skip("degenerate after shard rounding")
    out = fz.run(campaign, d, "cpu", str(tmp_path))
    fz.check(campaign, d, out, join_oracle, multiset_digest)
    return d, out


def _jax_plan(plan):
    return JaxPlan(**dataclasses.asdict(plan))


def _pairs(keys, vals):
    return np.sort(np.asarray(keys).astype(np.uint64) << 32
                   | np.asarray(vals).astype(np.uint64))


@pytest.mark.parametrize("seed", fz.SEEDS["merge"])
def test_fuzz_join_vs_oracle(seed, tmp_path):
    d, out = _checked("merge", seed, tmp_path)
    res_j, plan_j = jphj.join(d["ik"], d["iv"], d["ok"], d["ov"],
                              _jax_plan(d["plan"]))
    assert out["plan"] == plan_from_jax(plan_j)
    got = out["res"]
    for f in ("probe_keys", "match_vals", "match_cnts", "build_counts"):
        np.testing.assert_array_equal(
            got[f], np.asarray(getattr(res_j, f)).reshape(-1), err_msg=f)
    np.testing.assert_array_equal(
        _pairs(got["probe_keys"], got["probe_vals"]),
        _pairs(np.asarray(res_j.probe_keys).reshape(-1),
               np.asarray(res_j.probe_vals).reshape(-1)))


@pytest.mark.parametrize("seed", fz.SEEDS["radix"])
def test_fuzz_radix_padded_vs_oracle(seed, tmp_path):
    """The padded radix pipeline (the radix passes, the plain tile probe)
    on random pass splits; the check includes zero pass overflow."""
    _checked("radix", seed, tmp_path)


@pytest.mark.parametrize("seed", fz.SEEDS["npj"])
def test_fuzz_npj_vs_oracle(seed, tmp_path):
    d, out = _checked("npj", seed, tmp_path)
    cols = [d[k] for k in ("ik", "iv", "ok", "ov")]
    jplan = jnpj.plan_npj(len(d["ik"]), load=d["load"])
    assert dataclasses.asdict(out["plan"]) == dataclasses.asdict(jplan)
    mv, mc, jfinal = jnpj.npj_join(*cols, jplan)
    assert dataclasses.asdict(out["input_plan"]) == \
        dataclasses.asdict(jfinal)
    np.testing.assert_array_equal(out["input"][0], np.asarray(mv))
    np.testing.assert_array_equal(out["input"][1], np.asarray(mc))
    jk, jv, jmv, jmc, _ = jnpj.npj_join(*cols, jplan, order="sorted")
    k, v, smv, smc = out["sorted"]
    np.testing.assert_array_equal(k, np.asarray(jk))
    np.testing.assert_array_equal(smv, np.asarray(jmv))
    np.testing.assert_array_equal(smc, np.asarray(jmc))
    np.testing.assert_array_equal(_pairs(k, v), _pairs(jk, jv))


@pytest.mark.parametrize("seed", fz.SEEDS["stream"])
def test_fuzz_stream_resume_vs_oracle(seed, tmp_path):
    """A spilling stream run, a crash (a random suffix of the chunk
    spills deleted) and the resumed run: resumed + live counts, and the
    1:1 rows of every chunk (the spilled ones replayed) against the
    oracle's."""
    _checked("stream", seed, tmp_path)


@pytest.mark.parametrize("seed", fz.SEEDS["cpra"])
def test_fuzz_cpra_vs_oracle(seed, tmp_path):
    """cpra_join on W gloo thread ranks, W in {2, 4, 8}: the ranks'
    summed cardinality and rows against the oracle, and each rank's sum
    against the JAX result's shard on W virtual devices."""
    d, out = _checked("cpra", seed, tmp_path)
    W = d["W"]
    mesh = jax.make_mesh((W,), ("x",), devices=jax.devices()[:W])
    res_j, _ = jax_cpra_join(d["ik"], d["iv"], d["ok"], d["ov"], mesh,
                             _jax_plan(d["plan"]), slack=4.0, retries=3)
    shards = np.asarray(res_j.match_cnts).reshape(W, -1).astype(
        np.int64).sum(1)
    assert out["tuples"] == shards.tolist()


@pytest.mark.parametrize("seed", fz.SEEDS["grace"])
def test_fuzz_grace_dist_vs_oracle(seed, tmp_path):
    """grace_join_dist on random rank counts, fanouts and superchunk
    sizes: the global cardinality on every rank, equal partition counts
    on every rank, and the full row digest through the expansion."""
    _checked("grace", seed, tmp_path)


def _same_rows(got, want):
    """Two column-join outputs with the same columns, dtypes and rows
    (tests/test_torch_columns.py `_agree`)."""
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
    rows = [sorted(zip(*(np.asarray(o[n]).tolist() for n in sorted(o))))
            for o in (got, want)]
    assert rows[0] == rows[1]


@pytest.mark.parametrize("seed", fz.SEEDS["columns"])
def test_fuzz_column_join_modes_vs_oracle(seed, tmp_path):
    """join_columns in its four modes and join_columns_multi on the keys'
    two halves, against the (outer row, inner row) multiset of each mode
    (the semantics of tests/test_columns.py `_check_mode`) and against
    the JAX package's on the same draw."""
    d, out = _checked("columns", seed, tmp_path)
    args = (d["ik"], d["inner_cols"], d["ok"], d["outer_cols"])
    for how in fz.HOWS:
        _same_rows(out[how], jcols.join_columns(*args, how=how)[0])
    halves = [((k >> 16).astype(np.int32), (k & 0xFFFF).astype(np.int32))
              for k in (d["ik"], d["ok"])]
    want, _ = jcols.join_columns_multi(halves[0], d["inner_cols"], halves[1],
                                       d["outer_cols"], how=d["multi_how"])
    _same_rows(out["multi"], want)


@pytest.mark.parametrize("seed", fz.SEEDS["aggregate"])
def test_fuzz_chunked_aggregate_vs_numpy(seed, tmp_path):
    """The two-level aggregate matches numpy exactly (overflow 0) or
    counts its dropped partials; the auto wrapper is exact either way.
    Each of the three aggregates equals the JAX package's slot for slot:
    group count, keys, sums, counts (and the chunked one's overflow)."""
    d, out = _checked("aggregate", seed, tmp_path)
    keys, vals = jnp.asarray(d["keys"]), jnp.asarray(d["vals"])
    kw = dict(chunks=d["chunks"], partial_cap=d["cap"])
    for name, fn, k in (("chunked", jagg.hash_aggregate_chunked, kw),
                        ("auto", jagg.hash_aggregate_auto, kw),
                        ("single", jagg.hash_aggregate, {})):
        want = fn(keys, vals, **k)
        assert len(out[name]) == len(want), name
        for i, (g, w) in enumerate(zip(out[name], want)):
            np.testing.assert_array_equal(
                np.asarray(g).astype(np.int64),
                np.asarray(w).astype(np.uint32).astype(np.int64),
                err_msg=f"{name}[{i}]")
