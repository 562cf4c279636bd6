"""CLI drivers, argv-compatible with the reference binaries and with the
JAX package's ``cli.py``.

    python -m hash_join_codes_knl_tpu_torch.cli write <threads> <outer> <inner> [selc] [zipf]
    python -m hash_join_codes_knl_tpu_torch.cli npj   <threads> <outer> <inner> [ratio]
    python -m hash_join_codes_knl_tpu_torch.cli phj   <threads> <outer> <inner> [ratio]
    python -m hash_join_codes_knl_tpu_torch.cli cpra  <threads> <outer> <inner> [ratio]

Positional argv mirrors the reference mains (npj.cpp:932-935,
phj.cpp:1962-1965, write.cpp:1680-1686).  The joins run on the card by
default, on the CPU with ``--device cpu`` (the kernels' plain versions).
Without a card and without ``--device cpu`` a join exits 1 with a
message; it never carries on on the CPU.

<threads> is the number of ranks for cpra, for npj (> 1: the replicated
shared table, parallel/npj_dist.py) and for phj --grace-bits (> 1: the
distributed pass and partition-parallel joins, parallel/grace_dist.py):
clamped to the ranks of the torch.distributed world and floored to a
power of two.  Run several ranks with torchrun, one process per card
(``torchrun --nproc-per-node 4 -m hash_join_codes_knl_tpu_torch.cli cpra
4 ...``; NCCL on the card, gloo with ``--device cpu``); without torchrun
the world is one rank.  Every rank loads the same relations; rank 0
prints the report, and every rank exits with the same code.  cpra runs
``cpra_join``; ``--timelog`` meters the exchange and the local join as
two phases, and ``--chunks N`` (with more than one rank) pipelines the
probe side's exchange in N chunks.  <ratio> (the DDR/MCDRAM placement
knob) drives cpra's two-level tier hash over the mesh's halves when
there are two ranks or more, and is accepted for compatibility
otherwise: one card has one memory tier.  ``phj --stream-chunk-rows N
[--spill-dir D]`` streams the probe side from host RAM
(engine/stream.py, JSON keys ``chunks``, ``resumed_chunks``,
``chunk_rows``, ``window``); ``phj --grace-bits B --spill-dir D
[--stream-chunk-rows N]`` partitions both sides out of core
(engine/grace.py, keys ``partitions``, ``max_build_partition``,
``max_probe_partition``; without --spill-dir it exits 1).

write generates ik_/iv_/ok_/ov_<N>.txt on the host; the join drivers
load those files (falling back to in-memory generation when absent), run
the pipeline, verify cardinality against the analytic formula where it
is exact, and print phase times + throughput.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import numpy as np


def _load_or_generate(args):
    """Returns (inner, outer, generated).  Only MISSING files fall back
    to in-memory generation; a truncated or corrupt file raises
    (silently regenerating would run the benchmark on different data
    than the user's files)."""
    from .relation import load_relation
    from .relgen.generate import generate

    try:
        inner = load_relation("inner", args.inner, args.dir)
        outer = load_relation("outer", args.outer, args.dir)
        return inner, outer, False
    except FileNotFoundError:
        mode = "ref" if args.outer <= args.inner else "uniform"
        inner, outer, _ = generate(args.seed, args.inner, args.outer,
                                   mode=mode)
        return inner, outer, True


def _expected_tuples(args, generated: bool):
    """Analytic expected join cardinality (npj.cpp:937-942), or None
    when the expectation is not exact: outer > inner (stochastic
    uniform outer walk), or on-disk relations whose selectivity is
    unknown (pass --selc to assert it)."""
    from .relation import expected_join_tuples

    if args.outer > args.inner:
        return None
    selc = 1.0 if generated else args.selc
    if selc is None:
        return None
    return expected_join_tuples(args.inner, args.outer, selc)


def _finish(args, alg, timer, generated, join_tuples, extras=None,
            report=True):
    """Shared epilogue: cardinality gate (exact, in Python ints), report
    (rank 0's only).  Returns the process exit code."""
    expect = _expected_tuples(args, generated)
    if expect is not None and join_tuples != expect:
        print(f"CARDINALITY MISMATCH: got {join_tuples} want {expect}",
              file=sys.stderr)
        return 1
    if report:
        _report(alg, timer, args.outer, join_tuples, args.json, extras)
    return 0


def _report(alg, timer, outer_n, join_tuples, as_json, extras=None):
    metrics = timer.metrics(
        algorithm=alg,
        outer_tuples=outer_n,
        join_tuples=join_tuples,
        tuples_per_s=round(outer_n / max(timer.total, 1e-9), 1),
    )
    if extras:
        metrics.update(extras)
    if as_json:
        print(json.dumps(metrics))
    else:
        for k, v in metrics.items():
            print(f"{k:>16}: {v}")


def _parser():
    p = argparse.ArgumentParser(prog="hash_join_codes_knl_tpu_torch")
    p.add_argument("algorithm", choices=["write", "npj", "phj", "cpra"])
    p.add_argument("threads", type=int, nargs="?", default=1)
    p.add_argument("outer", type=int, nargs="?", default=200_000_000)
    p.add_argument("inner", type=int, nargs="?", default=200_000_000)
    p.add_argument("arg4", type=float, nargs="?", default=None,
                   help="ratio (joins) or selc (write)")
    p.add_argument("zipf", type=float, nargs="?", default=0.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--selc", type=float, default=None,
                   help="join selectivity of the ON-DISK relations (the "
                        "selc they were written with); enables the exact "
                        "cardinality check for file-loaded data (in-"
                        "memory generated data is always checked)")
    p.add_argument("--dir", default=".")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the joins run: the card (default) or the "
                        "CPU, with the kernels' plain versions")
    p.add_argument("--timelog", action="store_true",
                   help="per-phase breakdown (TIMELOG analog, hj.h:69-70) "
                        "+ roofline fractions; phj runs the merge stages "
                        "one by one")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to DIR "
                        "(chrome trace JSON)")
    p.add_argument("--chunks", type=int, default=0,
                   help="cpra: split the probe side into N chunks and "
                        "pipeline their exchange with the probe "
                        "(make_cpra_step_pipelined; more than one rank)")
    p.add_argument("--stream-chunk-rows", type=int, default=0,
                   help="phj out-of-core mode: keep the probe side in "
                        "host RAM and stream it through the card in "
                        "chunks of this many rows (engine/stream.py); "
                        "with --grace-bits, the partition pass's chunk")
    p.add_argument("--grace-bits", type=int, default=0,
                   help="phj Grace mode: both relations out of core, "
                        "radix-partitioned into 2^B partition files, "
                        "then joined partition by partition "
                        "(engine/grace.py; needs --spill-dir)")
    p.add_argument("--spill-dir", default=None,
                   help="with --stream-chunk-rows: spill per-chunk "
                        "results there and resume completed chunks; "
                        "with --grace-bits: the partition files")
    p.add_argument("--check", action="store_true",
                   help="phj: run the BG-debug-mode analog after the "
                        "join (oracle-free invariant re-checks: key "
                        "conservation checksums, pad hygiene, window "
                        "monotonicity; phj.cpp:1034-1041,1214-1229)")
    p.add_argument("--sorted-order", action="store_true",
                   help="npj: return/count results in home-bucket-"
                        "sorted order (the PHJ merge contract) -- one "
                        "probe-side sort instead of two "
                        "(engine/npj.py order='sorted')")
    p.add_argument("--aggregate", action="store_true",
                   help="phj: hash-aggregate the join output (group "
                        "matched rows by probe key, sum matched build "
                        "values) and print group count + sum checksum")
    p.add_argument("--config", metavar="FILE", default=None,
                   help="JSON file of JoinPlan fields (p_bits, slots, "
                        "tile, window, probe_chunks, pass_bits, "
                        "partition_impl, probe_impl, factor, ...) -- the "
                        "runtime form of the reference's compile-time "
                        "-D knobs (makefile:1-4)")
    return p


def _refusal(args):
    """The message for a flag combination or a mode this CLI does not
    run (exit code 2), or None.  A requested stage that a mode cannot run
    errors, never silently skips."""
    if (args.check or args.aggregate) and args.algorithm == "phj" and (
        args.stream_chunk_rows > 0 or args.grace_bits > 0
    ):
        return ("--check/--aggregate are not supported with "
                "--stream-chunk-rows/--grace-bits (per-chunk results "
                "stream through spill files; aggregate the spilled "
                "columns instead)")
    if args.sorted_order and (args.algorithm != "npj" or args.threads > 1):
        return "--sorted-order applies to the single-chip npj driver only"
    return None


def _mesh_devices(threads: int) -> int:
    """argv <threads> -> the mesh's rank count: clamped to the ranks of
    the world and floored to a power of two (the exchange's contract);
    threads <= 0 degenerates to 1."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = max(1, min(threads, world))
    return 1 << (n.bit_length() - 1)


def _write(args) -> int:
    from .relgen.generate import generate_to_dir

    selc = 1.0 if args.arg4 is None else args.arg4
    mode = ("zipf" if args.zipf > 0
            else ("ref" if args.outer <= args.inner else "uniform"))
    meta = generate_to_dir(args.dir, args.seed, args.inner, args.outer,
                           selc=selc, zipf=args.zipf, mode=mode)
    print(json.dumps({k: v for k, v in meta.items() if k != "factors"}))
    return 0


def _npj(args, timer, inner, outer, device):
    """The single-device NPJ driver: build, then the sorted probe at the
    auto window.  Returns (exit code, join tuples)."""
    import torch

    from .engine.npj import npj_build, npj_probe_sorted, plan_npj
    from .utils.hashing import u32_to_device

    ik = timer.run("load_device", u32_to_device, inner.keys, device)
    iv = u32_to_device(inner.vals, device)
    ok = u32_to_device(outer.keys, device)
    plan = plan_npj(len(ik))
    tk, tv, bovf, max_disp = timer.run("build", npj_build, ik, iv, plan)
    if int(bovf) > 0:
        # overflow is a VALUE, never silent: tuples parked past the
        # table margin would vanish here
        print(f"NPJ build overflow: {int(bovf)} tuples past the table "
              "margin; re-run via npj_join (auto re-plan)", file=sys.stderr)
        return 1, None
    window = plan.window or plan.auto_window(len(ok))
    if args.sorted_order:
        ov = u32_to_device(outer.vals, device)
        _, _, mv, mc, wovf = timer.run(
            "probe", npj_probe_sorted, tk, tv, ok, plan, max_disp, window,
            probe_vals=ov, order="sorted")
    else:
        mv, mc, wovf = timer.run("probe", npj_probe_sorted, tk, tv, ok,
                                 plan, max_disp, window)
    if int(wovf) > 0:
        print("NPJ probe window overflow: re-run via npj_join (auto "
              "re-plan)", file=sys.stderr)
        return 1, None
    return 0, int(mc.sum(dtype=torch.int64))


def _plan(args, ni: int, no: int, device):
    from .engine.config import plan_join

    plan = plan_join(ni, no, device=device)
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
        if "pass_bits" in overrides:
            overrides["pass_bits"] = tuple(overrides["pass_bits"])
        plan = dataclasses.replace(plan, **overrides)
    return plan


def _aggregate(timer, res, ik, iv) -> None:
    """Hash aggregate over the join output: group matched rows by probe
    key, sum matched build values; an M:N result (duplicate build keys)
    streams its expansion through device blocks instead."""
    from .ops.aggregate import (
        aggregate_join_result,
        aggregate_join_result_expanded,
    )
    from .utils.hashing import to_numpy_u32

    try:
        ng, _gk, gsum, _gc = timer.run("aggregate", aggregate_join_result,
                                       res)
    except ValueError:
        ng, _gk, gsum, _gc = timer.run(
            "aggregate", aggregate_join_result_expanded, res, ik, iv)
    g = int(ng)
    csum = int(to_numpy_u32(gsum[:g]).astype(np.uint64).sum())
    print(f"AGGREGATE: {g} groups, sum-checksum {csum}", file=sys.stderr)


def _phj(args, timer, inner, outer, device):
    """The in-memory PHJ driver.  Returns (exit code, join tuples,
    roofline or None)."""
    from .engine.phj import _merge_params, join, phj_join_merge_staged
    from .utils.hashing import u32_to_device

    ik = timer.run("load_device", u32_to_device, inner.keys, device)
    iv = u32_to_device(inner.vals, device)
    ok, ov = (u32_to_device(c, device) for c in (outer.keys, outer.vals))
    plan = _plan(args, len(ik), len(ok), device)
    staged = args.timelog and plan.probe_impl.startswith("merge")
    if staged:
        res = phj_join_merge_staged(ik, iv, ok, ov, plan, timer)
        win_ovf, _, opt_viol = res.build_counts.tolist()
        if opt_viol:
            # plan-opt violation (unique_build duplicates): widening the
            # window can never fix this
            print("PLAN-OPT VIOLATION (unique_build/two-class wide_cap): "
                  "re-run without --timelog (auto downgrade) or drop the "
                  "flag via --config", file=sys.stderr)
            return 1, None, None
        if win_ovf:
            # the staged path pins its geometry for phase metering, so
            # overflow cannot be re-planned here -- report it (never
            # silent) and point at the auto re-planner
            print("PROBE WINDOW OVERFLOW: re-run without --timelog (auto "
                  "re-plan) or widen window via --config", file=sys.stderr)
            return 1, None, None
    else:
        # the auto re-planner: merge-probe window overflow is measured and
        # re-planned, and padded/radix overflow raises -- exit 1 either way
        try:
            res, plan = timer.run("partition+build+probe", join, ik, iv, ok,
                                  ov, plan)
        except RuntimeError as e:
            print(f"OVERFLOW: {e}; adjust --config", file=sys.stderr)
            return 1, None, None
    join_tuples = int(res.join_tuples)
    if args.check:
        from .engine.validate import validate_join_result

        stats = timer.run("check", validate_join_result, res, outer.keys,
                          plan)
        print(f"CHECK OK: {stats}", file=sys.stderr)
    if args.aggregate:
        _aggregate(timer, res, ik, iv)
    roofline = None
    if staged:
        # merge pipeline only: the traffic model describes its sort,
        # window and probe stages; `plan` is the one the join ran with
        from .utils.roofline import merge_phj_traffic, roofline_report

        ni, no = len(inner.keys), len(outer.keys)
        tile, window, _, _ = _merge_params(plan, ni, no)
        roofline = roofline_report(timer.phases,
                                   merge_phj_traffic(ni, no, tile, window),
                                   device)
    return 0, join_tuples, roofline


def _cpra(args, timer, inner, outer, mesh):
    """The CPRA driver on `mesh`: cpra_join, the staged exchange and
    local join (--timelog), or the pipelined step (--chunks with more
    than one rank).  Returns (exit code, join tuples over the ranks)."""
    from .engine.config import plan_join
    from .engine.phj import downgrade_plan_opts, replan_from_span
    from .parallel.cpra import (
        cpra_join,
        make_cpra_step_pipelined,
        make_cpra_steps_staged,
    )
    from .parallel.distributed import shard_null_padded
    from .utils.timing import PhaseTimer

    ni, no, n = len(inner.keys), len(outer.keys), mesh.size
    if not (args.timelog or (args.chunks > 1 and n > 1)):
        res, _ = timer.run("exchange+join", cpra_join, inner.keys,
                           inner.vals, outer.keys, outer.vals, mesh,
                           tier_ratio=args.arg4)
        return 0, int(mesh.all_sum([int(res.join_tuples)])[0])
    plan = mesh.root_call(plan_join, ni // n, no // n, device=mesh.device)
    cols = [shard_null_padded(c, mesh) for c in
            (inner.keys, inner.vals, outer.keys, outer.vals)]
    if args.chunks > 1 and n > 1:
        step = make_cpra_step_pipelined(
            mesh, plan, inner_cap=max(64, 4 * ni // (n * n)),
            outer_cap=max(plan.tile * args.chunks, 4 * no // (n * n)),
            chunks=args.chunks)
        res, ovf = timer.run("pipelined exchange+join", step, *cols)
        if ovf:
            print("OVERFLOW: raise caps/chunks", file=sys.stderr)
            return 1, None
        return 0, int(mesh.all_sum([int(res.join_tuples)])[0])
    # staged phase metering: the exchange (the re-aggregation copy the
    # reference times on its own, cpra2.cpp:1895-1905) and the local join
    slack, tier_bias = 2.0, 1.0
    if args.arg4 is not None and n >= 2:
        tier_bias = 2.0 * max(args.arg4, 1.0 - args.arg4)
    for _ in range(3):
        ex, jo = make_cpra_steps_staged(
            mesh, plan, max(64, int(ni / n**2 * slack * tier_bias)),
            max(plan.tile, int(no / n**2 * slack * tier_bias)),
            tier_ratio=args.arg4 if n >= 2 else None)
        # a fresh timer per attempt: an overflowed attempt must not
        # inflate the reported exchange / local_join split
        att = PhaseTimer()
        *exchanged, eovf = att.run("exchange", ex, *cols)
        res, jovf = att.run("local_join", jo, *exchanged)
        if not (eovf or jovf):
            timer.phases.update(att.phases)
            timer.timeline.extend(att.timeline)
            return 0, int(mesh.all_sum([int(res.join_tuples)])[0])
        if jovf and plan.probe_impl.startswith("merge"):
            # a window too narrow for the received spans: more slack only
            # adds pads, so re-plan from the measured span as cpra_join
            # does (the JAX CLI doubles the slack here too)
            win, sel = mesh.all_sum(res.build_counts[[0, 2]].tolist())
            span = int(mesh.all_max([int(res.build_counts[1])])[0])
            if sel:
                plan = downgrade_plan_opts(plan)
            if win:
                plan = replan_from_span(plan, span)
        if eovf or not plan.probe_impl.startswith("merge"):
            slack *= 2.0
        res = exchanged = None
    print("OVERFLOW persists after re-planning", file=sys.stderr)
    return 1, None


def _npj_dist(timer, inner, outer, mesh):
    """npj with <threads> > 1: the replicated shared table."""
    from .engine.npj import plan_npj
    from .parallel.npj_dist import npj_join_dist

    _, _, join_tuples, _ = timer.run(
        "build+probe", npj_join_dist, inner.keys, inner.vals, outer.keys,
        outer.vals, mesh, plan_npj(len(inner.keys)))
    return 0, join_tuples


def _out_of_core(args, timer, inner, outer, device, mesh):
    """phj --grace-bits or --stream-chunk-rows: both relations stay on
    the host; the drivers stage what they need.  With a mesh (<threads>
    > 1), Grace runs over its ranks.  Returns (exit code, algorithm,
    join tuples, report extras)."""
    if args.grace_bits > 0:
        from .engine.grace import grace_join
        from .parallel.grace_dist import grace_join_dist

        if not args.spill_dir:
            print("--grace-bits needs --spill-dir", file=sys.stderr)
            return 1, None, None, None
        chunk = args.stream_chunk_rows or 32_000_000
        if mesh is not None:
            gres = timer.run(
                "grace_join", grace_join_dist, inner.keys, inner.vals,
                outer.keys, outer.vals, mesh, f_bits=args.grace_bits,
                chunk_rows=max(128, chunk // mesh.size),
                spill_dir=args.spill_dir)
        else:
            gres = timer.run(
                "grace_join", grace_join, inner.keys, inner.vals,
                outer.keys, outer.vals, f_bits=args.grace_bits,
                chunk_rows=chunk, spill_dir=args.spill_dir, device=device)
        return 0, "phj-grace", gres.join_tuples, {
            "partitions": 1 << gres.f_bits,
            "max_build_partition": max(
                (m.build_rows for m in gres.partitions), default=0),
            "max_probe_partition": max(
                (m.probe_rows for m in gres.partitions), default=0)}
    from .engine.stream import stream_join

    sres = timer.run("stream_join", stream_join, inner.keys, inner.vals,
                     outer.keys, outer.vals, args.stream_chunk_rows,
                     spill_dir=args.spill_dir, device=device)
    return 0, "phj-stream", sres.join_tuples, {
        "chunks": len(sres.chunks),
        "resumed_chunks": sres.resumed_chunks,
        "chunk_rows": args.stream_chunk_rows,
        "window": sres.plan.window}


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.algorithm == "write":
        return _write(args)
    refusal = _refusal(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2

    import torch

    from .utils.timing import PhaseTimer

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available: the joins run on the card; "
              "pass --device cpu to run the plain versions on the host",
              file=sys.stderr)
        return 1
    device = torch.device(args.device)
    profiling = contextlib.ExitStack()
    with profiling:
        if args.profile:
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            profiling.enter_context(profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(args.profile)))
        mesh = _mesh(args)
        inner, outer, generated = _load_or_generate(args)
        timer = PhaseTimer()
        extras = None
        alg = args.algorithm
        if alg == "phj" and (args.grace_bits > 0
                             or args.stream_chunk_rows > 0):
            rc, alg, join_tuples, extras = _out_of_core(
                args, timer, inner, outer, device, mesh)
        elif alg == "cpra":
            rc, join_tuples = _cpra(args, timer, inner, outer, mesh)
        elif alg == "npj" and mesh is not None:
            rc, join_tuples = _npj_dist(timer, inner, outer, mesh)
        elif alg == "npj":
            rc, join_tuples = _npj(args, timer, inner, outer, device)
        else:
            rc, join_tuples, extras = _phj(args, timer, inner, outer,
                                           device)
    if not rc:
        rc = _finish(args, alg, timer, generated, join_tuples, extras,
                     report=mesh is None or mesh.rank == 0)
    # every rank exits with the same code
    return rc if mesh is None else int(mesh.all_max([rc])[0])


def _mesh(args):
    """The ranks' mesh for the distributed modes (cpra, and npj or phj
    --grace-bits with <threads> > 1), else None.  Brings up the process
    group from torchrun's environment when there is one."""
    if not (args.algorithm == "cpra" or (args.threads > 1 and (
            args.algorithm == "npj" or (args.algorithm == "phj"
                                        and args.grace_bits > 0)))):
        return None
    from .parallel.distributed import data_mesh, initialize

    initialize(device=args.device)
    return data_mesh(_mesh_devices(args.threads),
                     device="cpu" if args.device == "cpu" else None)


if __name__ == "__main__":
    sys.exit(main())
