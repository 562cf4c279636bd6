"""The port's single-device CLI against the JAX package's CLI on the
CPU, on the same argv (the port's with ``--device cpu``): the files
`write` produces are byte-identical, and join_tuples, the AGGREGATE
line and the CHECK OK stats are equal; the cardinality gate and the
flag errors exit as the JAX CLI's do (tests/test_cli.py's single-device
cases); the distributed modes (cpra, npj and phj --grace-bits with
<threads> > 1) report as the JAX CLI's do, in one process and over
four torchrun ranks."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from hash_join_codes_knl_tpu.cli import main as jax_main
from hash_join_codes_knl_tpu_torch.cli import main

CPU = ["--device", "cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(capsys, fn, argv):
    """(exit code, last stdout line parsed as JSON or None, stderr)."""
    rc = fn(argv)
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    out = None
    if lines:
        try:
            out = json.loads(lines[-1])
        except ValueError:
            pass
    return rc, out, cap.err


def _both(capsys, argv):
    return _run(capsys, main, argv + CPU), _run(capsys, jax_main, argv)


def _stat_lines(err):
    """The CHECK OK and AGGREGATE lines of a run's standard error."""
    return [line for line in err.splitlines()
            if line.startswith(("CHECK OK:", "AGGREGATE:"))]


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("argv", [
    ["write", "1", "4096", "4096", "--seed", "3"],
    ["write", "1", "8192", "1024", "0.5", "--seed", "5"],
    ["write", "1", "8192", "1024", "1.0", "0.75"],
], ids=["ref", "selc-0.5", "zipf-0.75"])
def test_write_byte_identical(tmp_path, capsys, argv):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    rc_t, meta_t, _ = _run(capsys, main, argv + ["--dir", str(port_dir)])
    rc_j, meta_j, _ = _run(capsys, jax_main, argv + ["--dir", str(jax_dir)])
    assert rc_t == rc_j == 0
    assert meta_t == meta_j and "factors" not in meta_t
    port, ref = _files(port_dir), _files(jax_dir)
    assert list(port) == list(ref) and len(port) == 4
    assert port == ref


def test_each_reads_the_others_files(tmp_path, capsys):
    assert jax_main(["write", "1", "4096", "4096", "--dir", str(tmp_path),
                     "--seed", "3"]) == 0
    capsys.readouterr()
    (rc_t, out_t, _), (rc_j, out_j, _) = _both(
        capsys, ["phj", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "3", "--json"])
    assert rc_t == rc_j == 0
    assert out_t["join_tuples"] == out_j["join_tuples"] == 4096
    assert out_t["tuples_per_s"] > 0


@pytest.mark.parametrize("extra", [[], ["--timelog"]],
                         ids=["re-planner", "staged"])
def test_phj_check_and_aggregate_like_jax(capsys, extra):
    argv = ["phj", "1", "8192", "1024", "--seed", "21", "--json", "--check",
            "--aggregate", *extra]
    (rc_t, out_t, err_t), (rc_j, out_j, err_j) = _both(capsys, argv)
    assert rc_t == rc_j == 0
    assert out_t["join_tuples"] == out_j["join_tuples"] == 8192
    assert set(out_t) == set(out_j)
    assert _stat_lines(err_t) == _stat_lines(err_j)
    assert "AGGREGATE: 1024 groups" in err_t and "CHECK OK:" in err_t
    if extra:
        for key in ("partition_build_s", "partition_probe_s", "windows_s",
                    "probe_s", "hbm_peak_gbps", "pipeline_pct_roofline"):
            assert key in out_t, key
        assert out_t["hbm_peak_source"] == "cpu (nominal DDR)"


def test_selc_files_checked_only_with_selc(tmp_path, capsys):
    assert main(["write", "1", "4096", "4096", "0.5", "--dir",
                 str(tmp_path), "--seed", "11"]) == 0
    capsys.readouterr()
    base = ["phj", "1", "4096", "4096", "--dir", str(tmp_path), "--seed",
            "11", "--json"]
    for extra, want_rc in (([], 0), (["--selc", "0.5"], 0),
                           (["--selc", "1.0"], 1)):
        (rc_t, out_t, err_t), (rc_j, out_j, _) = _both(capsys, base + extra)
        assert rc_t == rc_j == want_rc, extra
        if want_rc == 0:
            assert out_t["join_tuples"] == out_j["join_tuples"] == 2048
        else:
            assert "CARDINALITY MISMATCH" in err_t


def test_truncated_relation_raises(tmp_path):
    assert main(["write", "1", "4096", "4096", "--dir", str(tmp_path),
                 "--seed", "3"]) == 0
    p = tmp_path / "ik_4096.txt"
    p.write_bytes(p.read_bytes()[: 100 * 4])
    with pytest.raises(ValueError, match="truncat|read"):
        main(["phj", "1", "4096", "4096", "--dir", str(tmp_path)] + CPU)


def test_config_file_like_jax(tmp_path, capsys):
    cfg = tmp_path / "plan.json"
    cfg.write_text(json.dumps({"tile": 256, "window": 384,
                               "probe_impl": "merge_jnp"}))
    (rc_t, out_t, _), (rc_j, out_j, _) = _both(
        capsys, ["phj", "1", "4096", "1024", "--seed", "17", "--json",
                 "--config", str(cfg)])
    assert rc_t == rc_j == 0
    assert out_t["join_tuples"] == out_j["join_tuples"] == 4096


def test_config_window_overflow_staged_exits_1(tmp_path, capsys):
    """The staged path cannot re-plan: a window too narrow exits 1 in
    both CLIs; without --timelog the re-planner recovers."""
    cfg = tmp_path / "plan.json"
    cfg.write_text(json.dumps({"tile": 1024, "window": 128,
                               "probe_chunks": 8, "pass_bits": [4]}))
    argv = ["phj", "1", "8192", "1024", "--seed", "17", "--json",
            "--config", str(cfg)]
    (rc_t, _, err_t), (rc_j, _, _) = _both(capsys, argv + ["--timelog"])
    assert rc_t == rc_j == 1
    assert "PROBE WINDOW OVERFLOW" in err_t
    (rc_t, out_t, _), (rc_j, out_j, _) = _both(capsys, argv)
    assert rc_t == rc_j == 0
    assert out_t["join_tuples"] == out_j["join_tuples"] == 8192


@pytest.mark.parametrize("argv", [
    ["npj", "1", "2048", "2048", "--seed", "5", "--json"],
    ["npj", "1", "8192", "2048", "--seed", "33", "--json"],
    ["npj", "1", "8192", "2048", "--seed", "33", "--json",
     "--sorted-order"],
])
def test_npj_like_jax(capsys, argv):
    (rc_t, out_t, _), (rc_j, out_j, _) = _both(capsys, argv)
    assert rc_t == rc_j == 0
    assert out_t["join_tuples"] == out_j["join_tuples"] == int(argv[2])
    assert set(out_t) == set(out_j)
    assert "build_s" in out_t and "probe_s" in out_t


def test_phj_aggregate_mn_like_jax(tmp_path, capsys):
    """Duplicate build keys (selc 0.5 over 1024 inner rows): the
    aggregate streams the expansion, with JAX's group count and sum
    checksum."""
    assert main(["write", "1", "8192", "1024", "0.5", "--dir",
                 str(tmp_path), "--seed", "5"]) == 0
    capsys.readouterr()
    (rc_t, out_t, err_t), (rc_j, out_j, err_j) = _both(
        capsys, ["phj", "1", "8192", "1024", "--dir", str(tmp_path),
                 "--json", "--aggregate", "--check"])
    assert rc_t == rc_j == 0
    assert out_t["join_tuples"] == out_j["join_tuples"]
    assert "aggregate_s" in out_t
    assert _stat_lines(err_t) == _stat_lines(err_j)
    g = int(re.search(r"AGGREGATE: (\d+) groups", err_t).group(1))
    assert 0 < g <= 512


def _same_report(out_t, out_j):
    """Equal reports up to the timings: every key but the seconds and the
    rate, with equal values."""
    def fixed(out):
        return {k: v for k, v in out.items()
                if not k.endswith("_s") and k != "tuples_per_s"}

    assert fixed(out_t) == fixed(out_j)


@pytest.mark.parametrize("argv", [
    ["cpra", "1", "2048", "1024"],
    ["cpra", "8", "8192", "1024", "--timelog"],
    ["cpra", "8", "8192", "1024", "0.75"],
    ["cpra", "8", "8192", "1024", "--chunks", "4"],
    ["cpra", "2", "8192", "1024", "--seed", "7", "--timelog", "0.5"],
    ["npj", "2", "4096", "512"],
    ["phj", "4", "4096", "1024", "--grace-bits", "2",
     "--stream-chunk-rows", "2048"],
], ids=["cpra", "cpra-timelog", "cpra-tier", "cpra-chunks",
        "cpra-timelog-tier", "npj-threads", "grace-threads"])
def test_distributed_modes_like_jax(capsys, tmp_path, argv):
    """The distributed modes through both CLIs on the same argv: equal
    exit codes, join_tuples and reports (with no torchrun world the
    port's <threads> clamps to one rank, where the JAX CLI takes that
    many virtual devices), nothing on standard error."""
    if "--grace-bits" in argv:
        outs = _out_of_core_both(capsys, tmp_path, argv + ["--json"])
        _same_report(*outs)
        assert outs[0]["algorithm"] == "phj-grace"
        return
    (rc_t, out_t, err_t), (rc_j, out_j, err_j) = _both(capsys,
                                                       argv + ["--json"])
    assert rc_t == rc_j == 0
    assert err_t == err_j == ""
    _same_report(out_t, out_j)
    assert out_t["join_tuples"] == int(argv[2])
    if "--timelog" in argv:
        assert {"exchange_s", "local_join_s"} <= set(out_t) & set(out_j)


def test_cpra_timelog_replans_a_narrow_window(capsys, monkeypatch):
    """The staged cpra pins its geometry per attempt: a local window too
    narrow for the received spans is re-planned from the measured span
    (more slack would only add pads), and the reported phases are the
    successful attempt's."""
    import dataclasses

    from hash_join_codes_knl_tpu_torch.engine import config

    plan_join = config.plan_join
    monkeypatch.setattr(config, "plan_join", lambda *a, **k: dataclasses.replace(
        plan_join(*a, **k), tile=1024, window=128, probe_chunks=8))
    rc, out, err = _run(capsys, main, ["cpra", "1", "8192", "1024",
                                       "--timelog", "--json"] + CPU)
    assert rc == 0, err
    assert out["join_tuples"] == 8192
    assert {"exchange_s", "local_join_s"} <= set(out)


def test_cpra_under_torchrun_like_jax(capsys):
    """cpra over four gloo ranks (torchrun, --device cpu), the pipelined
    step: rank 0 alone prints the report, equal to the JAX CLI's over
    four virtual devices, and every rank exits 0."""
    argv = ["cpra", "4", "16384", "1024", "--chunks", "4", "--json"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "--no-python", sys.executable, "-m",
         "hash_join_codes_knl_tpu_torch.cli", *argv, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    reports = [json.loads(line) for line in proc.stdout.splitlines()
               if line.startswith("{")]
    assert len(reports) == 1
    rc_j, out_j, _ = _run(capsys, jax_main, argv)
    assert rc_j == 0
    assert set(reports[0]) == set(out_j)
    _same_report(reports[0], out_j)
    assert "pipelined exchange+join_s" in reports[0]


def _out_of_core_both(capsys, tmp_path, argv, runs=1):
    """Each CLI with its own --spill-dir, `runs` times; returns the last
    (port, JAX) reports."""
    outs = []
    for name, fn, extra in (("port", main, CPU), ("jax", jax_main, [])):
        d = str(tmp_path / name)
        for _ in range(runs):
            rc, out, err = _run(capsys, fn, argv + ["--spill-dir", d,
                                                    *extra])
            assert rc == 0, err
        outs.append(out)
    assert set(outs[0]) == set(outs[1])
    return outs


def test_stream_like_jax(capsys, tmp_path):
    argv = ["phj", "1", "8192", "1024", "--seed", "11", "--json",
            "--stream-chunk-rows", "2048"]
    keys = ("algorithm", "join_tuples", "chunks", "resumed_chunks",
            "chunk_rows", "window")
    first = _out_of_core_both(capsys, tmp_path / "a", argv)
    assert first[0]["algorithm"] == "phj-stream"
    assert first[0]["chunks"] == 4 and first[0]["resumed_chunks"] == 0
    resumed = _out_of_core_both(capsys, tmp_path / "b", argv, runs=2)
    assert resumed[0]["resumed_chunks"] == 4
    for t, j in (first, resumed):
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
        assert t["join_tuples"] == 8192 and "stream_join_s" in t


def test_grace_like_jax(capsys, tmp_path):
    argv = ["phj", "1", "8192", "2048", "--seed", "19", "--json",
            "--grace-bits", "2", "--stream-chunk-rows", "4096"]
    t, j = _out_of_core_both(capsys, tmp_path, argv)
    keys = ("algorithm", "join_tuples", "partitions", "max_build_partition",
            "max_probe_partition")
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    assert t["algorithm"] == "phj-grace" and t["partitions"] == 4
    assert t["join_tuples"] == 8192 and "grace_join_s" in t


def test_grace_without_spill_dir_exits_1(capsys):
    (rc_t, out_t, err_t), (rc_j, _, err_j) = _both(
        capsys, ["phj", "1", "4096", "1024", "--grace-bits", "2"])
    assert rc_t == rc_j == 1 and out_t is None
    assert "--grace-bits needs --spill-dir" in err_t
    assert "--grace-bits needs --spill-dir" in err_j


@pytest.mark.parametrize("argv", [
    ["phj", "1", "4096", "1024", "--sorted-order"],
    ["npj", "2", "4096", "1024", "--sorted-order"],
    ["phj", "1", "4096", "1024", "--check", "--stream-chunk-rows", "64"],
    ["phj", "1", "4096", "1024", "--aggregate", "--grace-bits", "2"],
], ids=["sorted-order-phj", "sorted-order-threads", "check-stream",
        "aggregate-grace"])
def test_flag_errors_like_jax(capsys, argv):
    (rc_t, _, err_t), (rc_j, _, err_j) = _both(capsys, argv)
    assert rc_t == rc_j == 2
    assert err_t == err_j


@pytest.mark.parametrize("alg", ["phj", "npj"])
def test_no_card_without_device_cpu_exits_nonzero(capsys, alg):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    rc, out, err = _run(capsys, main, [alg, "1", "2048", "512", "--json"])
    assert rc == 1 and out is None
    assert "no CUDA device" in err and "--device cpu" in err


def test_profile_writes_a_trace(tmp_path, capsys):
    rc, out, _ = _run(capsys, main, ["phj", "1", "2048", "512", "--seed",
                                     "15", "--json", "--profile",
                                     str(tmp_path / "trace")] + CPU)
    assert rc == 0 and out["join_tuples"] == 2048
    assert any(f.name.endswith(".json")
               for f in os.scandir(tmp_path / "trace"))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cpra_tears_down_the_group_it_brought_up(capsys, monkeypatch):
    """A world of one brought up from torchrun-style environment
    variables: the CLI destroys the group it made before it returns, so
    the interpreter's exit never tears gloo down (which can abort)."""
    import torch.distributed as dist

    for var, value in (("WORLD_SIZE", "1"), ("RANK", "0"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(var, value)
    assert not dist.is_initialized()
    rc, out, err = _run(capsys, main, ["cpra", "1", "4096", "512",
                                       "--json"] + CPU)
    assert rc == 0, err
    assert out["join_tuples"] == 4096
    assert not dist.is_initialized()


def test_cpra_keeps_the_callers_group(capsys):
    """A group the caller set up stays up after the CLI returns."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        rc, out, err = _run(capsys, main, ["cpra", "1", "4096", "512",
                                           "--json"] + CPU)
        assert rc == 0, err
        assert out["join_tuples"] == 4096
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
