"""The port's out-of-core streaming join (engine/stream.py) against the
JAX package's stream_join on the CPU.

Exact: chunk counts, per-chunk and total join_tuples, the final plan and
the resume pattern are equal.  The on_chunk columns are flat in the port
(live tensors and resumed numpy columns alike); against the JAX columns,
flattened, probe keys, match values and match counts agree slot for
slot and probe values as (key, value) pairs (the JAX probe sort is
unstable).  Rows are compared by multiset_digest against join_oracle.
Spill directories interchange: a JAX spill resumes in the port with the
oracle's digest, and a port spill in the JAX package."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from hash_join_codes_knl_tpu.engine import stream as jstream
from hash_join_codes_knl_tpu.engine.config import plan_join as jax_plan_join
from hash_join_codes_knl_tpu_torch.engine import stream as tstream
from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan
from hash_join_codes_knl_tpu_torch.engine.convert import plan_from_jax
from hash_join_codes_knl_tpu_torch.engine.oracle import (
    join_oracle,
    multiset_digest,
)
from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

CHUNK = 4096
_port_replay = functools.partial(tstream.replay_probe_columns, device="cpu")


def _jax_plan(plan: JoinPlan):
    from hash_join_codes_knl_tpu.engine.config import JoinPlan as JaxPlan

    return JaxPlan(**dataclasses.asdict(plan))


@pytest.fixture(scope="module")
def workload():
    """A probe side of hits and misses whose length is no multiple of the
    chunk (a short tail)."""
    rng = np.random.default_rng(23)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, 2048, dtype=np.uint32)
    hits = ik[rng.integers(0, 2048, 9000)]
    miss = rng.integers(1, 2**32, 1500, dtype=np.uint32)
    ok = np.concatenate([hits, miss]).astype(np.uint32)
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    return ik, iv, ok, ov


def _flat(res) -> dict:
    """A chunk's payload as flat host columns, from either package."""
    if isinstance(res, (tstream.SpilledChunk, jstream.SpilledChunk)):
        return {"match_vals": np.asarray(res.match_vals).reshape(-1),
                "match_cnts": np.asarray(res.match_cnts).reshape(-1)}
    if isinstance(res.match_cnts, torch.Tensor):
        assert all(getattr(res, f).dim() == 1 for f in
                   ("probe_keys", "probe_vals", "match_vals", "match_cnts"))
        return {"probe_keys": to_numpy_u32(res.probe_keys),
                "probe_vals": to_numpy_u32(res.probe_vals),
                "match_vals": to_numpy_u32(res.match_vals),
                "match_cnts": res.match_cnts.numpy()}
    return {f: np.asarray(getattr(res, f)).reshape(-1) for f in
            ("probe_keys", "probe_vals", "match_vals", "match_cnts")}


def _collect(store):
    def on_chunk(cm, res):
        store.append((cm, _flat(res)))
    return on_chunk


def _rows(cols):
    m = cols["match_cnts"] == 1
    return cols["probe_keys"][m], cols["probe_vals"][m], cols["match_vals"][m]


def _digest(chunks):
    return multiset_digest(*(np.concatenate(c) for c in
                             zip(*(_rows(cols) for _, cols in chunks))))


def _both(ik, iv, ok, ov, chunk_rows=CHUNK, plan=None, **kw):
    got, want = [], []
    t = tstream.stream_join(ik, iv, ok, ov, chunk_rows, plan=plan,
                            on_chunk=_collect(got), device="cpu", **kw)
    j = jstream.stream_join(ik, iv, ok, ov, chunk_rows,
                            plan=None if plan is None else _jax_plan(plan),
                            on_chunk=_collect(want), **kw)
    assert t.join_tuples == j.join_tuples
    assert [dataclasses.astuple(c) for c in t.chunks] == \
        [dataclasses.astuple(c) for c in j.chunks]
    assert t.plan == plan_from_jax(j.plan)
    return t, got, want


def _assert_columns_agree(got, want):
    for (_, g), (_, w) in zip(got, want, strict=True):
        for f in ("probe_keys", "match_vals", "match_cnts"):
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)
        pairs = [np.sort(c["probe_keys"].astype(np.uint64) << 32
                         | c["probe_vals"]) for c in (g, w)]
        np.testing.assert_array_equal(*pairs)


@pytest.mark.parametrize("chunk_rows", [CHUNK, 20_000],
                         ids=["three-chunks", "one-short-chunk"])
def test_stream_matches_jax(workload, chunk_rows):
    ik, iv, ok, ov = workload
    t, got, want = _both(ik, iv, ok, ov, chunk_rows)
    assert len(t.chunks) == -(-len(ok) // chunk_rows)
    assert t.chunks[-1].rows == len(ok) - (len(t.chunks) - 1) * chunk_rows
    _assert_columns_agree(got, want)
    assert _digest(got) == multiset_digest(*join_oracle(ik, iv, ok, ov))
    assert t.transfer == {}  # no copy stream on the CPU


def test_window_replan_on_skewed_chunk():
    """Chunk 1 is duplicate-heavy and overflows an explicit narrow
    window: both packages widen the window alike and stay exact."""
    rng = np.random.default_rng(83)
    ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
    iv = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    hot = ik[rng.integers(0, 16, 4096)].astype(np.uint32)
    uni = ik[rng.integers(0, 4096, 4096)].astype(np.uint32)
    ok = np.concatenate([uni, hot]).astype(np.uint32)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    plan = dataclasses.replace(
        plan_from_jax(jax_plan_join(4096, 4096, tile=512)), window=384)
    t, got, want = _both(ik, iv, ok, ov, 4096, plan)
    assert t.plan.window > 384
    _assert_columns_agree(got, want)
    assert t.join_tuples == len(join_oracle(ik, iv, ok, ov)[0])


def test_span_past_the_gather_cap_raises():
    """A duplicate run too wide for the pinned geometry raises in both
    packages: the window-only re-plan cannot absorb it."""
    rng = np.random.default_rng(29)
    heavy = np.uint32(12345)
    uniq = np.unique(rng.integers(1, 2**32, 4200, dtype=np.uint32))
    uniq = uniq[uniq != heavy][:3384]
    ik = np.concatenate([np.full(13000, heavy, np.uint32), uniq])
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = np.full(4096, heavy, np.uint32)
    ov = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="gather cap"):
        tstream.stream_join(ik, iv, ok, ov, 4096, device="cpu")
    with pytest.raises(RuntimeError, match="gather cap"):
        jstream.stream_join(ik, iv, ok, ov, 4096)


def test_plan_opt_violation_downgrades(workload):
    """unique_build declared on a duplicate-key build: the counted
    violation downgrades the flag, the geometry stays, the count is
    exact."""
    ik, iv, ok, ov = workload
    ik2 = np.concatenate([ik, ik[:256]])
    iv2 = np.concatenate([iv, iv[:256] ^ np.uint32(0x5A5A5A5A)])
    plan = JoinPlan(p_bits=4, slots=256, tile=512,
                    probe_impl="merge_gather", window=1280,
                    unique_build=True)
    t = tstream.stream_join(ik2, iv2, ok, ov, CHUNK, plan=plan,
                            device="cpu")
    assert not t.plan.unique_build and t.plan.window == plan.window
    assert t.join_tuples == len(join_oracle(ik2, iv2, ok, ov)[0])


def _corrupt(path, at=13):
    blob = bytearray(path.read_bytes())
    blob[at] ^= 0xFF
    path.write_bytes(bytes(blob))


@pytest.mark.parametrize("damage", ["corrupt", "missing", "input"])
def test_resume_recomputes_a_damaged_chunk(tmp_path, workload, damage):
    ik, iv, ok, ov = workload
    d = tmp_path / "spill"
    first = tstream.stream_join(ik, iv, ok, ov, CHUNK, spill_dir=str(d),
                                device="cpu")
    assert first.resumed_chunks == 0
    if damage == "corrupt":
        _corrupt(d / "chunk_000001_mval.bin")
    elif damage == "missing":
        (d / "chunk_000001_mcnt.bin").unlink()
    else:
        ok = ok.copy()
        ok[CHUNK + 4] = ik[7]  # chunk 1's input changes
    second = tstream.stream_join(ik, iv, ok, ov, CHUNK, spill_dir=str(d),
                                 device="cpu")
    assert [c.resumed for c in second.chunks] == [True, False, True]
    assert second.join_tuples == len(join_oracle(ik, iv, ok, ov)[0])
    third = tstream.stream_join(ik, iv, ok, ov, CHUNK, spill_dir=str(d),
                                device="cpu")
    assert third.resumed_chunks == 3


def test_changed_build_or_plan_recomputes(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    tstream.stream_join(ik, iv, ok, ov, CHUNK, spill_dir=d, device="cpu")
    iv2 = iv ^ np.uint32(0x5A5A5A5A)
    assert tstream.stream_join(ik, iv2, ok, ov, CHUNK, spill_dir=d,
                               device="cpu").resumed_chunks == 0
    base = plan_from_jax(jax_plan_join(len(ik), CHUNK))
    other = dataclasses.replace(base, factor=0x85EBCA77)
    assert tstream.stream_join(ik, iv2, ok, ov, CHUNK, plan=other,
                               spill_dir=d, device="cpu").resumed_chunks == 0
    assert tstream.stream_join(ik, iv2, ok, ov, CHUNK, plan=other,
                               spill_dir=d, device="cpu").resumed_chunks == 3


def _replayed(ok, ov, plan, replay):
    """on_chunk for resumed runs: the spilled match columns with the
    probe columns rebuilt by `replay` (either package's)."""
    store = []

    def on_chunk(cm, payload):
        assert isinstance(payload, (tstream.SpilledChunk,
                                    jstream.SpilledChunk))
        sl = slice(cm.index * CHUNK, min((cm.index + 1) * CHUNK, len(ok)))
        pk, pv = replay(ok[sl], ov[sl], plan, len(payload.match_vals))
        store.append((cm, {"probe_keys": np.asarray(pk).reshape(-1),
                           "probe_vals": np.asarray(pv).reshape(-1),
                           **_flat(payload)}))
    return store, on_chunk


def test_jax_spill_resumes_in_port(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    j = jstream.stream_join(ik, iv, ok, ov, CHUNK, spill_dir=d)
    plan = plan_from_jax(j.plan)
    rows, on_chunk = _replayed(ok, ov, plan, _port_replay)
    t = tstream.stream_join(ik, iv, ok, ov, CHUNK, plan=plan, spill_dir=d,
                            on_chunk=on_chunk, device="cpu")
    assert t.resumed_chunks == 3 and t.join_tuples == j.join_tuples
    assert _digest(rows) == multiset_digest(*join_oracle(ik, iv, ok, ov))


def test_port_spill_resumes_in_jax(tmp_path, workload):
    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    t = tstream.stream_join(ik, iv, ok, ov, CHUNK, spill_dir=d,
                            device="cpu")
    jplan = _jax_plan(t.plan)
    rows, on_chunk = _replayed(ok, ov, jplan, jstream.replay_probe_columns)
    j = jstream.stream_join(ik, iv, ok, ov, CHUNK, plan=jplan, spill_dir=d,
                            on_chunk=on_chunk)
    assert j.resumed_chunks == 3 and j.join_tuples == t.join_tuples
    assert _digest(rows) == multiset_digest(*join_oracle(ik, iv, ok, ov))


def test_replay_realigns_slot_for_slot(tmp_path, workload):
    """The port's replay equals its live probe columns slot for slot,
    and the JAX replay's keys slot for slot (values as pairs); a port
    spill then resumes with the live run's exact columns."""
    ik, iv, ok, ov = workload
    d = str(tmp_path / "spill")
    live = []
    t = tstream.stream_join(ik, iv, ok, ov, CHUNK, spill_dir=d,
                            on_chunk=_collect(live), device="cpu")
    rows, on_chunk = _replayed(ok, ov, t.plan, _port_replay)
    tstream.stream_join(ik, iv, ok, ov, CHUNK, plan=t.plan, spill_dir=d,
                        on_chunk=on_chunk, device="cpu")
    jrows, jon_chunk = _replayed(ok, ov, _jax_plan(t.plan),
                                 jstream.replay_probe_columns)
    jstream.stream_join(ik, iv, ok, ov, CHUNK, plan=_jax_plan(t.plan),
                        spill_dir=d, on_chunk=jon_chunk)
    for (_, a), (_, b) in zip(live, rows, strict=True):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    _assert_columns_agree(rows, jrows)
