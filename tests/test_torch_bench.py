"""The port's bench harness on the CPU, against the JAX package's: the
headline bench (bench_torch.py vs bench.py), the out-of-core benches
(scripts/torch_bench_stream.py, torch_bench_grace.py), the weak-scaling
run (torch_bench_scaling.py) and the span statistics, at tiny sizes with
``--device cpu``: exact counts, and reports with the JAX scripts' keys
(read from their sources: the JAX scripts themselves run minutes)."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _load(rel):
    """A root file or a script of the repo as a module."""
    path = os.path.join(REPO, rel)
    name = "_hjk_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _report_keys(rel, marker):
    """The string keys of the largest dict literal in a repo file whose
    keys include `marker`: a JAX script's report."""
    tree = ast.parse(open(os.path.join(REPO, rel)).read())
    best = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if marker in keys and len(keys) > len(best):
                best = keys
    assert best, (rel, marker)
    return best


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_torch_like_bench(capsys, monkeypatch):
    """bench_torch.py at 4096 x 16384: the exact join_tuples, equal to
    the JAX package's phj_join on the same generate() output, and
    bench.py's keys plus the device's."""
    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.engine.phj import phj_join
    from hash_join_codes_knl_tpu.relgen.generate import generate

    for var, value in (("HJK_BENCH_INNER", "4096"),
                       ("HJK_BENCH_OUTER", "16384"), ("HJK_BENCH_REPS", "2")):
        monkeypatch.setenv(var, value)
    _load("bench_torch.py").main(CPU)
    out = _last_json(capsys)
    inner, outer, _ = generate(seed=42, inner_tuples=4096,
                               outer_tuples=16384, mode="uniform")
    res = phj_join(inner.keys, inner.vals, outer.keys, outer.vals,
                   plan_join(4096, 16384))
    assert out["join_tuples"] == int(res.join_tuples) == 16384
    assert set(out) == _report_keys("bench.py", "pct_feasible_floor") | {
        "device"}
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert set(out["anchors"]) >= _report_keys("bench.py", "probe_sort_s")
    assert out["seconds"] > 0 and out["anchors"]["build_sort_s"] > 0
    # the achievable anchor is the least probe sort timed, the plan's
    # chunk count and C=2048 among them: no floor above the feasible one
    sorts = out["anchors"]["probe_sort_s_by_chunks"]
    assert {str(max(1, out["plan"]["probe_chunks"])), "2048"} <= set(sorts)
    assert out["anchors"]["achievable_probe_sort_s"] == min(sorts.values())
    assert out["pct_achievable_floor"] <= out["pct_feasible_floor"]


def test_bench_torch_wrong_cardinality_exits_1(capsys, monkeypatch):
    """A wrong count prints bench.py's error line and exits 1."""
    from hash_join_codes_knl_tpu_torch.engine import phj

    real = phj.phj_join

    def short(*a):
        res = real(*a)
        res.match_cnts[:1] = 0
        return res

    monkeypatch.setattr(phj, "phj_join", short)
    monkeypatch.setenv("HJK_BENCH_INNER", "2048")
    monkeypatch.setenv("HJK_BENCH_OUTER", "8192")
    with pytest.raises(SystemExit) as exc:
        _load("bench_torch.py").main(CPU)
    assert exc.value.code == 1
    out = _last_json(capsys)
    assert out["error"] == "wrong cardinality: got 8191 want 8192"
    assert out["value"] == 0.0


def test_sync_run_median_after_warm_up():
    """The matrix's timing: fn(0) as the untimed warm-up, then the median
    of fn(1..reps); every run made once, in order."""
    from hash_join_codes_knl_tpu_torch.utils import bench as hb

    calls = []
    waits = {1: 0.03, 2: 0.0, 3: 0.01}

    def fn(rep):
        calls.append(rep)
        time.sleep(waits.get(rep, 0.0))

    t = hb.sync_run(fn, "cpu", 3)
    assert calls == [0, 1, 2, 3]
    assert 0.01 <= t < 0.03


@pytest.mark.parametrize("entry", [
    "bench_torch.py", "scripts/torch_bench_configs.py",
    "scripts/torch_bench_stream.py", "scripts/torch_bench_grace.py",
    "scripts/torch_bench_scaling.py", "scripts/torch_profile_headline.py",
    "scripts/torch_span_stats.py"])
def test_entry_points_need_the_card(capsys, entry):
    """Without a card and without --device cpu each exits 1 and says
    so; none runs on the host unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    main = _load(entry).main
    with pytest.raises(SystemExit) as exc:
        main() if entry.endswith("profile_headline.py") else main([])
    assert exc.value.code == 1
    cap = capsys.readouterr()
    assert "no CUDA device is available" in cap.err
    assert cap.out == ""


def test_bench_torch_without_card_exits_1():
    """As a user runs it: a process that exits 1."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "no CUDA device is available" in proc.stderr


@pytest.mark.parametrize("miss", [0.0, 0.25])
def test_stream_bench_exact_like_jax(capsys, tmp_path, miss):
    spill = str(tmp_path / "spill")
    rc = _load("scripts/torch_bench_stream.py").main(
        ["--outer", "60000", "--inner", "4096", "--chunk", "16384",
         "--spill-dir", spill, "--miss", str(miss)] + CPU)
    out = _last_json(capsys)
    assert rc == 0
    assert out["cardinality_exact"] is True
    assert out["chunks"] == 4 and out["spill"] is True
    if miss:
        assert out["join_tuples"] < 60000
    else:
        assert out["join_tuples"] == 60000
    assert set(out) == _report_keys("scripts/bench_stream.py", "h2d_gb")


def test_grace_bench_exact_like_jax(capsys, tmp_path, monkeypatch):
    """Exact, the JAX script's keys, and the default spill directory is
    a fresh temp dir, removed afterwards."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = _load("scripts/torch_bench_grace.py").main(
        ["--build", "8192", "--probe", "50000", "--f-bits", "2",
         "--chunk", "16384"] + CPU)
    out = _last_json(capsys)
    assert rc == 0
    assert out["cardinality_exact"] is True and out["join_tuples"] == 50000
    assert out["partitions"] == 4
    assert out["reused_sides"] == {"build": False, "probe": False}
    assert set(out) == _report_keys("scripts/bench_grace.py", "transfer_gb")
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("grace_bench_")]


def test_scaling_bench_exact_like_jax(capsys, tmp_path):
    """Thread ranks 1, 2 and 4: every size exact (the JAX package's
    expected count of the m-times relations), the JAX script's keys per
    size, and the serialization-corrected efficiency beside the raw."""
    from hash_join_codes_knl_tpu.relation import expected_join_tuples

    out_path = str(tmp_path / "scaling.json")
    rc = _load("scripts/torch_bench_scaling.py").main(
        ["--inner", "2048", "--outer", "16384", "--reps", "1", "--ranks",
         "4", "--out", out_path] + CPU)
    assert rc == 0
    res = json.load(open(out_path))
    keys = _report_keys("scripts/bench_scaling.py",
                        "serialization_corrected_efficiency")
    for m in (1, 2, 4):
        row = res[str(m)]
        assert set(row) == keys
        assert row["devices"] == m
        assert row["join_tuples"] == expected_join_tuples(2048 * m,
                                                          16384 * m)
        assert set(row["stage_seconds"]) == {"exchange", "local_join"}
        assert 0 < row["serialization_corrected_efficiency"] <= 1
    assert res["1"]["weak_scaling_efficiency"] == 1.0
    assert res["_device"] == {"name": "cpu", "power_limit": None}
    assert "mesh=  4" in capsys.readouterr().out


def test_span_stats_spans_every_tile(capsys):
    """The spans of every probe tile: as many as the padded probe has
    tiles, quantiles ascending, the widest the largest span."""
    import argparse

    mod = _load("scripts/torch_span_stats.py")
    geo = dict(inner=16384, outer=131072, tile=896, chunks=4, zipf=1.0)
    assert mod.main([f"--{k}={v}" for k, v in geo.items()] + CPU) == 0
    lines = capsys.readouterr().out.splitlines()
    n_tiles = int(lines[0].split("n_tiles=")[1])
    assert n_tiles == -(-131072 // (896 * 4)) * 4
    qs = [int(t.split("=")[1]) for t in lines[1].split()[2:]]
    assert qs == sorted(qs) and 0 < qs[-1] <= 16384 + 128
    span = mod.spans(argparse.Namespace(window=0, **geo),
                     torch.device("cpu"))[0]
    assert len(span) == n_tiles and int(np.max(span)) == qs[-1]


def test_span_stats_like_jax(capsys, monkeypatch):
    """At one probe chunk the two scripts print the same lines.  (With
    more chunks scripts/span_stats.py slices the JAX package's 2-D probe
    sort as if it were flat and raises; the port's sort is flat.)"""
    argv = ["--inner", "16384", "--outer", "131072", "--tile", "896",
            "--chunks", "1"]
    assert _load("scripts/torch_span_stats.py").main(argv + CPU) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["span_stats.py", *argv])
    _load("scripts/span_stats.py").main()
    assert port == capsys.readouterr().out
