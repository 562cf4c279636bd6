"""The port's Grace join (engine/grace.py) against the JAX package's
grace_join on the CPU (the JAX radix pass in interpret mode, as
tests/test_grace.py runs it).

Exact: per-partition build and probe counts, the sidecars' per-partition
u64 checksums, per-partition and total join_tuples.  Partition files
agree as (key, value) multisets (a file's row order follows its pass).
Rows through on_partition are compared by multiset_digest against
join_oracle.  Partition files written by either package are reused by
the other."""

import json
import os

import numpy as np
import pytest
import torch

import hash_join_codes_knl_tpu.engine.grace as jgrace
import hash_join_codes_knl_tpu_torch.engine.grace as tgrace
from hash_join_codes_knl_tpu_torch.engine.oracle import (
    join_oracle,
    multiset_digest,
)
from hash_join_codes_knl_tpu_torch.engine.phj import JoinResult
from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(53)
    ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
    iv = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    hits = ik[rng.integers(0, 4096, 18000)]
    miss = rng.integers(1, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate([hits, miss]).astype(np.uint32)
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    return ik, iv, ok, ov


def _port(*a, **kw):
    return tgrace.grace_join(*a, device="cpu", **kw)


def _rows_into(store):
    def on_partition(meta, res, raw_pk):
        if isinstance(res.match_cnts, torch.Tensor):
            mc = res.match_cnts.numpy()
            pv, mv = to_numpy_u32(res.probe_vals), to_numpy_u32(res.match_vals)
        else:
            mc = np.asarray(res.match_cnts)
            pv, mv = np.asarray(res.probe_vals), np.asarray(res.match_vals)
        m = mc == 1
        store.append((raw_pk[m], pv[m], mv[m]))
    return on_partition


def _digest(store):
    return multiset_digest(*(np.concatenate(c) for c in zip(*store)))


def _side_files(d, side, F):
    meta = json.load(open(os.path.join(d, f"{side}_partition.json")))
    files = []
    for p in range(F):
        k, v = (np.fromfile(os.path.join(d, f"{side}_{p}_{c}.bin"), "<u4")
                for c in ("hk", "val"))
        files.append(np.sort(k.astype(np.uint64) << 32 | v))
    return meta, files


def test_grace_matches_jax(tmp_path, workload):
    """Both sides stream through the pass in 5000-row chunks into 8
    partitions: equal counts, checksums, file multisets and joins."""
    ik, iv, ok, ov = workload
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    rows = []
    t = _port(ik, iv, ok, ov, f_bits=3, chunk_rows=5000, spill_dir=td,
              on_partition=_rows_into(rows))
    j = jgrace.grace_join(ik, iv, ok, ov, f_bits=3, chunk_rows=5000,
                          spill_dir=jd)
    assert t.join_tuples == j.join_tuples == len(join_oracle(ik, iv, ok,
                                                             ov)[0])
    assert [(m.index, m.build_rows, m.probe_rows, m.join_tuples)
            for m in t.partitions] == \
        [(m.index, m.build_rows, m.probe_rows, m.join_tuples)
         for m in j.partitions]
    assert t.host_skew_chunks == 0
    assert set(t.seconds) == {"partition", "join"}
    for side in ("build", "probe"):
        tm, tf = _side_files(td, side, 8)
        jm, jf = _side_files(jd, side, 8)
        assert tm == jm
        for a, b in zip(tf, jf):
            np.testing.assert_array_equal(a, b)
    assert _digest(rows) == multiset_digest(*join_oracle(ik, iv, ok, ov))


def test_duplicate_build_keys(tmp_path, workload):
    ik, iv, ok, ov = workload
    dup_k = np.concatenate([ik, ik[:512]]).astype(np.uint32)
    dup_v = np.concatenate([iv, iv[:512] ^ 1]).astype(np.uint32)
    t = _port(dup_k, dup_v, ok, ov, f_bits=2, chunk_rows=7000,
              spill_dir=str(tmp_path / "g"))
    assert t.join_tuples == len(join_oracle(dup_k, dup_v, ok, ov)[0])


def test_guards(tmp_path, workload):
    ik, iv, ok, ov = workload
    with pytest.raises(ValueError, match="chunk_rows"):
        _port(ik, iv, ok, ov, f_bits=3, chunk_rows=0,
              spill_dir=str(tmp_path / "z"))
    with pytest.raises(ValueError, match="spill_dir"):
        _port(ik, iv, ok, ov)
    # the budget error names the fanout to use instead
    for fn in (_port, jgrace.grace_join):
        with pytest.raises(RuntimeError, match="f_bits=4"):
            fn(ik, iv, ok, ov, f_bits=2, chunk_rows=8000,
               spill_dir=str(tmp_path / "b"), partition_budget_rows=100)


def test_exact_join_tuples_above_u32():
    """A partition with more than 2^32 output rows does not wrap: the
    port's join_tuples, which grace_join sums, is the exact int64 sum."""
    n = 2_000_000
    cnts = np.full(n, 2400, np.int32)
    cnts[: n // 2] ^= 7
    want = int(cnts.astype(np.int64).sum())
    z = torch.zeros(n, dtype=torch.int32)
    res = JoinResult(z, z, z, torch.from_numpy(cnts),
                     torch.zeros(3, dtype=torch.int32))
    assert want > 2**32
    assert int(res.join_tuples) == want


def test_phase1_reuse_and_corrupt_file(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")
    r1 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d)
    assert r1.reused_sides == {"build": False, "probe": False}
    # another chunk size only permutes rows within the files: reused
    r2 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=5000, spill_dir=d)
    assert r2.reused_sides == {"build": True, "probe": True}
    assert r2.join_tuples == r1.join_tuples
    victim = next(os.path.join(d, f"probe_{m.index}_hk.bin")
                  for m in r1.partitions if m.probe_rows and m.build_rows)
    raw = bytearray(open(victim, "rb").read())
    raw[0] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    # counts-only with a full journal never reads the file
    r3 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d)
    assert r3.join_tuples == r1.join_tuples
    # a row consumer reads it: the checksum fails and the probe side's
    # pass runs once more
    r4 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d,
               on_partition=lambda m, res, pk: None)
    assert r4.reused_sides == {"build": True, "probe": False}
    assert r4.join_tuples == r1.join_tuples
    # other routing is not reused
    r5 = _port(ik, iv, ok, ov, f_bits=3, chunk_rows=8000, spill_dir=d)
    assert r5.reused_sides == {"build": False, "probe": False}
    assert r5.join_tuples == r1.join_tuples


def test_phase2_journal_resume(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")
    r1 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d)
    n_live = sum(1 for m in r1.partitions if m.build_rows and m.probe_rows)
    assert r1.resumed_partitions == 0
    r2 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d)
    assert r2.resumed_partitions == n_live
    assert r2.join_tuples == r1.join_tuples
    path = tgrace._journal_path(d)
    lines = open(path).read().splitlines()
    with open(path, "w") as f:  # header, one record and a torn line
        f.write("\n".join(lines[:2]) + "\n" + lines[2][: len(lines[2]) // 2])
    r3 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d)
    assert r3.resumed_partitions == 1 and r3.join_tuples == r1.join_tuples
    seen = []
    r4 = _port(ik, iv, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d,
               on_partition=lambda m, res, pk: seen.append(m.index))
    assert r4.resumed_partitions == 0 and len(seen) == n_live
    # new payloads: the build side re-partitions, the journal restarts
    rows = []
    iv2 = (iv ^ np.uint32(0x5A5A5A5A)).astype(np.uint32)
    r5 = _port(ik, iv2, ok, ov, f_bits=2, chunk_rows=8000, spill_dir=d,
               on_partition=_rows_into(rows))
    assert r5.reused_sides == {"build": False, "probe": True}
    assert _digest(rows) == multiset_digest(*join_oracle(ik, iv2, ok, ov))


def test_hot_key_chunk_takes_the_host_path_in_both(tmp_path, monkeypatch):
    """A chunk dominated by one key overflows the pass's per-tile run
    bound at any capacity: both packages' partition passes put exactly
    that chunk through the host split, with equal counts and checksums
    (one capacity retry each, to keep the interpret-mode pass short),
    and the port's grace_join stays exact."""
    rng = np.random.default_rng(77)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    ok = ik[rng.integers(0, 2048, 8000)].astype(np.uint32)
    ok[:4000] = ik[5]  # chunk 0 of the probe side: one key
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    calls = []
    real = jgrace._host_partition_fragments

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(jgrace, "_host_partition_fragments", counted)
    factor = 0x9E3779B1
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jd)
    os.makedirs(td)
    want = jgrace._partition_side(ok, ov, factor, 4, 4000, jd, "probe",
                                  cap_retries=1)
    *got, host_chunks = tgrace._partition_side(
        ok, ov, factor, 4, 4000, td, "probe", device="cpu", cap_retries=1)
    assert host_chunks == len(calls) == 1
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == list(want[1:])
    (tm, tf), (jm, jf) = (_side_files(x, "probe", 16) for x in (td, jd))
    assert tm == jm
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a, b)
    t = _port(ik, iv, ok, ov, f_bits=4, chunk_rows=4000,
              spill_dir=str(tmp_path / "g"))
    assert t.host_skew_chunks == 1
    assert t.join_tuples == len(join_oracle(ik, iv, ok, ov)[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_partition_files_interchange(tmp_path, workload, writer):
    """Files written by one package are reused by the other: both sides
    reused, every partition resumed from the journal, and with a row
    consumer the rows read from those files give the oracle's digest."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "g")
    first, second = ((jgrace.grace_join, _port) if writer == "jax"
                     else (_port, jgrace.grace_join))
    r1 = first(ik, iv, ok, ov, f_bits=3, chunk_rows=6000, spill_dir=d)
    n_live = sum(1 for m in r1.partitions if m.build_rows and m.probe_rows)
    r2 = second(ik, iv, ok, ov, f_bits=3, chunk_rows=6000, spill_dir=d)
    assert r2.reused_sides == {"build": True, "probe": True}
    assert r2.resumed_partitions == n_live
    assert r2.join_tuples == r1.join_tuples
    rows = []
    r3 = second(ik, iv, ok, ov, f_bits=3, chunk_rows=6000, spill_dir=d,
                on_partition=_rows_into(rows))
    assert r3.reused_sides == {"build": True, "probe": True}
    assert r3.resumed_partitions == 0
    assert _digest(rows) == multiset_digest(*join_oracle(ik, iv, ok, ov))
