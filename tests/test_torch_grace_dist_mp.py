"""The port's distributed Grace join over two PROCESSES: two ranks under
torchrun with gloo on the CPU (tests/torch_mp_grace_worker.py), the
counterpart of tests/test_grace_dist_mp.py.

Holds what one process of thread ranks cannot: each process spills under
its own spill_dir/host<rank>, the totals are reconciled across
processes, a rerun resumes both phases in every process, and a corrupt
phase-1 file on one rank is refused by every rank.  Every launch has its
own time limit and is killed with all its processes past it; a failing
rank makes the launcher exit non-zero."""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_grace_worker.py")
TIMEOUT_S = 240


def _launch(data_dir, spill, consumer=False):
    """Two ranks of the worker under torchrun; (exit code, RESULT lines
    by rank, REFUSED lines by rank, standard error)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "--no-python", sys.executable, WORKER,
           data_dir, spill, "--device", "cpu"]
    if consumer:
        cmd.append("--consumer")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"the two ranks did not finish in {TIMEOUT_S} s")
    lines = {"RESULT": {}, "REFUSED": {}}
    for line in out.splitlines():
        tag, _, body = line.partition(" ")
        if tag in lines:
            rec = json.loads(body)
            lines[tag][rec["rank"]] = rec
    return proc.returncode, lines["RESULT"], lines["REFUSED"], err


def _results(data_dir, spill, consumer=False):
    rc, results, refused, err = _launch(data_dir, spill, consumer)
    assert rc == 0 and not refused, (rc, refused, err[-3000:])
    assert sorted(results) == [0, 1], err[-3000:]
    assert all(r["world"] == 2 for r in results.values())
    return results


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """tests/test_grace_dist_mp.py's workload (seed 83): 4096 unique build
    keys, 17,000 probes (14,000 hits)."""
    d = tmp_path_factory.mktemp("mpdata")
    rng = np.random.default_rng(83)
    ik = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4096]
    iv = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    hits = ik[rng.integers(0, 4096, 14000)]
    miss = rng.integers(1, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate([hits, miss]).astype(np.uint32)
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    for name, a in (("ik", ik), ("iv", iv), ("ok", ok), ("ov", ov)):
        np.save(os.path.join(str(d), f"{name}.npy"), a)
    return str(d), (ik, iv, ok, ov)


def test_grace_dist_two_processes(tmp_path, workload):
    """Totals global and equal on both ranks; the ranks' row digests sum
    to the oracle's (ownership is disjoint); the per-partition counts
    agree; each rank spilled under its own host<rank>."""
    data_dir, cols = workload
    spill = str(tmp_path / "mp_spill")
    results = _results(data_dir, spill, consumer=True)
    want = join_oracle(*cols)
    wc, ws1, ws2 = multiset_digest(*want)
    assert {r["total"] for r in results.values()} == {len(want[0])}
    c = sum(r["digest"][0] for r in results.values())
    s1 = sum(r["digest"][1] for r in results.values()) % (1 << 64)
    s2 = sum(r["digest"][2] for r in results.values()) % (1 << 64)
    assert (c, s1, s2) == (wc, ws1, ws2)
    seen0, seen1 = (set(results[r]["parts_seen"]) for r in (0, 1))
    assert seen0 and seen1 and not seen0 & seen1
    assert results[0]["meta_counts"] == results[1]["meta_counts"]
    assert sum(results[0]["meta_counts"]) == len(want[0])
    for r in (0, 1):
        assert os.listdir(os.path.join(spill, f"host{r}"))


def test_grace_dist_two_processes_resume(tmp_path, workload):
    """A counts-only rerun over the same per-rank spills reuses both
    sides' phase-1 files and resumes phase 2 from the journals on both
    ranks, with the same counts."""
    data_dir, cols = workload
    spill = str(tmp_path / "mp_spill_resume")
    want_total = len(join_oracle(*cols)[0])
    first = _results(data_dir, spill)
    assert {r["total"] for r in first.values()} == {want_total}
    assert all(not any(r["reused"].values()) for r in first.values())
    second = _results(data_dir, spill)
    assert {r["total"] for r in second.values()} == {want_total}
    for r in second.values():
        assert r["reused"] == {"build": True, "probe": True}
        assert r["resumed"] > 0
    assert (second[0]["meta_counts"] == second[1]["meta_counts"]
            == first[0]["meta_counts"])


def test_grace_dist_two_processes_refuse_corrupt_spill(tmp_path, workload):
    """With the journals gone, a corrupt phase-1 file of rank 1 is refused
    by both processes (recomputing one rank's phase 1 alone would run
    its collectives alone), and the launcher exits non-zero."""
    data_dir, _ = workload
    spill = str(tmp_path / "mp_spill_corrupt")
    _results(data_dir, spill)
    for r in (0, 1):
        os.remove(os.path.join(spill, f"host{r}", "join_progress.jsonl"))
    host1 = os.path.join(spill, "host1")
    victim = sorted(f for f in os.listdir(host1)
                    if f.startswith("probe_") and f.endswith("_val.bin")
                    and os.path.getsize(os.path.join(host1, f)))[0]
    a = np.fromfile(os.path.join(host1, victim), "<u4")
    a[0] ^= 1
    a.tofile(os.path.join(host1, victim))
    rc, results, refused, err = _launch(data_dir, spill)
    assert rc != 0 and not results, (rc, results)
    assert sorted(refused) == [0, 1], err[-3000:]
    assert "corrupt" in refused[1]["error"]
    assert "another rank" in refused[0]["error"]
