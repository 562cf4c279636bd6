"""The port's distributed Grace join (parallel/grace_dist.py) against the
JAX package's grace_join_dist on the same numpy inputs: W thread ranks
against W virtual CPU devices (the JAX radix pass in interpret mode).

Exact: per-partition build and probe counts and join_tuples, and the
total; rows through on_partition digest to join_oracle's.  A world of
one rank writes spill_dir as grace_join does, and its files are reused
by grace_join of either package and the other way round.  With more
than one rank each rank spills under host<rank> and resumes its own
files; a corrupt one is refused on every rank (the JAX package's
multi-process rule), where a world of one recomputes it."""

import os

import jax
import numpy as np
import pytest

import hash_join_codes_knl_tpu.engine.grace as jgrace
from hash_join_codes_knl_tpu.parallel.grace_dist import (
    grace_join_dist as jax_grace_join_dist,
)
from hash_join_codes_knl_tpu_torch.engine import grace as tgrace
from hash_join_codes_knl_tpu_torch.engine.oracle import (
    join_oracle,
    multiset_digest,
)
from hash_join_codes_knl_tpu_torch.parallel.distributed import (
    run_ranks,
    thread_meshes,
)
from hash_join_codes_knl_tpu_torch.parallel.grace_dist import grace_join_dist
from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(71)
    ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
    iv = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    hits = ik[rng.integers(0, 4096, 16000)]
    miss = rng.integers(1, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate([hits, miss]).astype(np.uint32)
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    return ik, iv, ok, ov


def _ranks(W, fn):
    return run_ranks(thread_meshes(W, "cpu", timeout_s=120), fn,
                     timeout_s=300)


def _jax(W, *cols, **kw):
    mesh = jax.make_mesh((W,), ("x",), devices=jax.devices()[:W])
    return jax_grace_join_dist(*cols, mesh, **kw)


def _metas(res):
    return [(m.index, m.build_rows, m.probe_rows, m.join_tuples)
            for m in res.partitions]


def _live(res):
    return sum(1 for m in res.partitions if m.build_rows and m.probe_rows)


def _collector(store):
    def on_partition(meta, res, raw_pk):
        assert res.build_counts.tolist()[0] == 0 and len(
            res.build_counts) == 3
        m = res.match_cnts.numpy() == 1
        store.append((raw_pk[m], to_numpy_u32(res.probe_vals)[m],
                      to_numpy_u32(res.match_vals)[m]))
    return on_partition


@pytest.mark.parametrize("W,f_bits,chunk", [(2, 2, 6000), (4, 4, 3000)])
def test_grace_dist_like_jax(tmp_path, workload, W, f_bits, chunk):
    """Several superchunks; per-partition counts and joins equal the JAX
    driver's, the same on every rank; rows conserve the oracle's."""
    ik, iv, ok, ov = workload
    want = _jax(W, ik, iv, ok, ov, f_bits=f_bits, chunk_rows=chunk,
                spill_dir=str(tmp_path / "jax"))
    stores = [[] for _ in range(W)]
    out = _ranks(W, lambda m: grace_join_dist(
        ik, iv, ok, ov, m, f_bits=f_bits, chunk_rows=chunk,
        spill_dir=str(tmp_path / "port"),
        on_partition=_collector(stores[m.rank])))
    oracle = join_oracle(ik, iv, ok, ov)
    for res in out:
        assert _metas(res) == _metas(want)
        assert res.join_tuples == want.join_tuples == len(oracle[0])
        assert res.host_skew_chunks == 0
    rows = [r for s in stores for r in s]
    assert multiset_digest(*(np.concatenate(c) for c in zip(*rows))) == \
        multiset_digest(*oracle)
    assert sorted(os.listdir(tmp_path / "port")) == [f"host{r}"
                                                     for r in range(W)]


def test_grace_dist_duplicate_build_keys(tmp_path, workload):
    ik, iv, ok, ov = workload
    dup_k = np.concatenate([ik, ik[:512]]).astype(np.uint32)
    dup_v = np.concatenate([iv, iv[:512] ^ 1]).astype(np.uint32)
    out = _ranks(2, lambda m: grace_join_dist(
        dup_k, dup_v, ok, ov, m, f_bits=2, chunk_rows=6000,
        spill_dir=str(tmp_path / "g")))
    want = len(join_oracle(dup_k, dup_v, ok, ov)[0])
    assert all(r.join_tuples == want for r in out)


def test_grace_dist_resume_over_ranks(tmp_path, workload):
    """A rerun over the same inputs reuses every rank's files and resumes
    every partition from the journals; other routing recomputes."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")

    def run(f_bits):
        return _ranks(4, lambda m: grace_join_dist(
            ik, iv, ok, ov, m, f_bits=f_bits, chunk_rows=2000,
            spill_dir=d))

    first, again, other = run(4), run(4), run(3)
    for r1, r2, r3 in zip(first, again, other):
        assert r1.reused_sides == {"build": False, "probe": False}
        assert r2.reused_sides == {"build": True, "probe": True}
        assert r2.resumed_partitions == _live(r1)
        assert r3.reused_sides == {"build": False, "probe": False}
        assert r1.join_tuples == r2.join_tuples == r3.join_tuples


def test_grace_dist_resume_agreement(tmp_path, workload):
    """When one rank lost its sidecar, every rank recomputes the side
    together (a lone recomputing rank would deadlock the others)."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")

    def run():
        return _ranks(2, lambda m: grace_join_dist(
            ik, iv, ok, ov, m, f_bits=2, chunk_rows=4000, spill_dir=d))

    first = run()
    os.remove(os.path.join(d, "host1", "probe_partition.json"))
    second = run()
    assert all(r.reused_sides == {"build": True, "probe": False}
               for r in second)
    assert second[0].join_tuples == first[0].join_tuples


def _corrupt(path):
    a = np.fromfile(path, "<u4")
    a[0] ^= 1
    a.tofile(path)


def test_grace_dist_corrupt_spill_refused_over_ranks(tmp_path, workload):
    """With more than one rank a corrupt reused file is refused, on every
    rank, instead of recomputed on one."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")

    def run():
        return _ranks(2, lambda m: grace_join_dist(
            ik, iv, ok, ov, m, f_bits=2, chunk_rows=4000, spill_dir=d))

    run()
    # journals gone: phase 2 must read the files again
    for r in range(2):
        os.remove(os.path.join(d, f"host{r}", "join_progress.jsonl"))
    _corrupt(os.path.join(d, "host0", "probe_0_hk.bin"))

    def body(m):
        with pytest.raises(RuntimeError) as e:
            grace_join_dist(ik, iv, ok, ov, m, f_bits=2, chunk_rows=4000,
                            spill_dir=d)
        return str(e.value)

    errors = run_ranks(thread_meshes(2, "cpu", timeout_s=120), body,
                       timeout_s=300)
    assert "corrupt" in errors[0] and "another rank" in errors[1]


def test_grace_dist_world_of_one_recomputes_corrupt_spill(tmp_path,
                                                           workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")
    mesh = thread_meshes(1, "cpu")[0]
    r1 = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=2, chunk_rows=4000,
                         spill_dir=d)
    os.remove(os.path.join(d, "join_progress.jsonl"))
    _corrupt(os.path.join(d, "build_1_val.bin"))
    r2 = grace_join_dist(ik, iv, ok, ov, mesh, f_bits=2, chunk_rows=4000,
                         spill_dir=d)
    assert r2.reused_sides["build"] is False
    assert r2.join_tuples == r1.join_tuples


def _port_single(*cols, **kw):
    return tgrace.grace_join(*cols, device="cpu", **kw)


def _port_dist_1(*cols, **kw):
    return grace_join_dist(*cols, thread_meshes(1, "cpu")[0], **kw)


@pytest.mark.parametrize("first,second", [
    (jgrace.grace_join, _port_dist_1), (_port_dist_1, jgrace.grace_join),
    (_port_single, _port_dist_1), (_port_dist_1, _port_single)],
    ids=["jax-then-dist", "dist-then-jax", "port-then-dist",
         "dist-then-port"])
def test_world_of_one_spill_interchange(tmp_path, workload, first, second):
    """A world of one writes spill_dir as grace_join does: either
    package's grace_join reuses its files and journal, and the other way
    round; with a row consumer the rows give the oracle's digest."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")
    r1 = first(ik, iv, ok, ov, f_bits=3, chunk_rows=6000, spill_dir=d)
    r2 = second(ik, iv, ok, ov, f_bits=3, chunk_rows=5000, spill_dir=d)
    assert r2.reused_sides == {"build": True, "probe": True}
    assert r2.resumed_partitions == _live(r1)
    assert r2.join_tuples == r1.join_tuples
    assert _metas(r2) == _metas(r1)
    if second is _port_dist_1:
        rows = []
        r3 = second(ik, iv, ok, ov, f_bits=3, chunk_rows=6000, spill_dir=d,
                    on_partition=_collector(rows))
        assert r3.resumed_partitions == 0
        assert multiset_digest(*(np.concatenate(c) for c in zip(*rows))) \
            == multiset_digest(*join_oracle(ik, iv, ok, ov))


def test_grace_dist_guards(tmp_path, workload):
    """f_bits below log2(ranks) and a partition past the budget raise on
    every rank, with the fix named."""
    ik, iv, ok, ov = workload

    def body(m):
        with pytest.raises(ValueError, match="f_bits"):
            grace_join_dist(ik, iv, ok, ov, m, f_bits=1, chunk_rows=4000,
                            spill_dir=str(tmp_path / "a"))
        with pytest.raises(RuntimeError, match="f_bits=4"):
            grace_join_dist(ik, iv, ok, ov, m, f_bits=2, chunk_rows=4000,
                            spill_dir=str(tmp_path / "b"),
                            partition_budget_rows=100)
        with pytest.raises(ValueError, match="spill_dir"):
            grace_join_dist(ik, iv, ok, ov, m)
        return True

    assert all(_ranks(4, body))


def test_grace_dist_hot_key_superchunk_host_split_like_jax(tmp_path):
    """One key on most of a block: the pass's run bound overflows at any
    capacity, the superchunk is split on the host, and the counts still
    equal the JAX driver's (fuzz seed 9401's shape)."""
    rng = np.random.default_rng(78)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    ok = ik[rng.integers(0, 2048, 16000)].astype(np.uint32)
    ok[:9000] = ik[9]
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    want = _jax(2, ik, iv, ok, ov, f_bits=4, chunk_rows=3000,
                spill_dir=str(tmp_path / "jax"))
    out = _ranks(2, lambda m: grace_join_dist(
        ik, iv, ok, ov, m, f_bits=4, chunk_rows=3000,
        spill_dir=str(tmp_path / "port")))
    assert all(_metas(r) == _metas(want) for r in out)
    assert out[0].host_skew_chunks > 0
    assert out[0].join_tuples == len(join_oracle(ik, iv, ok, ov)[0])
