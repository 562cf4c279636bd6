"""BASELINE.json config-matrix runner of the PyTorch/CUDA port (the
counterpart of scripts/bench_configs.py): the same rows under the same
names and fields, written to bench_results_torch.json.

  1. NPJ   uniform 16M x 256M (npj_uniform_full, its sorted-order twin)
           and the 4M x 16M npj_uniform row
  2. PHJ   uniform 16M x 256M (phj_uniform, bench_torch.py's workload)
  3. CPRA  on data_mesh(): a world of one, or every card under torchrun
  4. PHJ   Zipf z=0.75 and z=1.0 probe skew (join() re-plans first; the
           timed runs use its final plan)
 plus: the hash aggregate over the 256M probe rows (single level, and
 two-level and single-level at 64K groups), the reference CPRA's
 4096-way fanout (pass_bits=(6, 6)) through the padded radix engine at
 4M x 16M, and the NPJ chain-walk ablation at 1/8 probe volume
 (npj_chain, npj_chain_unique).

Every row is validated before it is timed: its cardinality against the
generator's count or a count of the probe keys' matches in the sorted
build keys (Zipf and chain rows), its overflow counters at zero, and at
--small the Zipf rows' digest against join_oracle.  Each timed run sits
between two synchronizes; a row's time is the median of its runs (1 to
3, bench_configs.py's counts, in the row's `reps`) after a checked
warm-up.  Each row carries bench_configs.py's fields, its join cardinality (or group
count) and the device's name and power limit.

Under torchrun every rank runs every row on its own card (cpra over all
of them) and rank 0 prints and writes the file.

Usage: python scripts/torch_bench_configs.py [--small] [--only substr]
       [--out FILE] [--device cpu]
(--only runs matching rows and MERGES into the existing results file.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from hash_join_codes_knl_tpu_torch.utils import bench as hb  # noqa: E402

# gate -> published row names, so --only matches either the gate or any
# row name (scripts/bench_configs.py's table)
GATE_ROWS = {
    "phj_uniform": ("phj_uniform",),
    "aggregate": ("hash_aggregate_256M",
                  "hash_aggregate_chunked_256M_64Kgroups",
                  "hash_aggregate_256M_64Kgroups"),
    "npj_uniform_full": ("npj_uniform_full",
                         "npj_uniform_full_sorted_order"),
    "zipf": ("phj_zipf_0.75", "phj_zipf_1.0"),
    "cpra": ("cpra",),
    "radix_4096": ("phj_radix_4096way",),
    "npj_uniform": ("npj_uniform",),
    "npj_chain": ("npj_chain", "npj_chain_unique"),
}
G_BITS = 16  # the low-cardinality aggregate rows fold keys to 64K groups


def match_count(build_keys: torch.Tensor, probe_keys: torch.Tensor) -> int:
    """Join cardinality by plain searches: for each probe key, the number
    of equal keys among the sorted build keys (uint32 bits, compared in
    int64)."""
    b = torch.sort(build_keys.to(torch.int64) & 0xFFFFFFFF).values
    p = probe_keys.to(torch.int64) & 0xFFFFFFFF
    p = p[p != 0]  # key 0 is the null key
    return int((torch.searchsorted(b, p, right=True)
                - torch.searchsorted(b, p)).sum())


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="smoke sizes (CI / CPU)")
    ap.add_argument("--out", default="bench_results_torch.json")
    ap.add_argument("--only", default=None,
                    help="run only rows whose name contains this "
                         "substring; merge results into --out instead "
                         "of overwriting")
    hb.add_device_arg(ap)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = hb.entry_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)

    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        process_group,
    )

    with process_group(device=dev):
        return run_rows(args, dev)


def run_rows(args, dev):
    from hash_join_codes_knl_tpu_torch.engine.config import (
        JoinPlan,
        plan_join,
    )
    from hash_join_codes_knl_tpu_torch.engine.npj import (
        npj_build,
        npj_probe,
        npj_probe_sorted,
        plan_npj,
    )
    from hash_join_codes_knl_tpu_torch.engine.oracle import (
        join_oracle,
        multiset_digest,
    )
    from hash_join_codes_knl_tpu_torch.engine.phj import (
        join,
        materialize,
        phj_join,
    )
    from hash_join_codes_knl_tpu_torch.ops.aggregate import (
        hash_aggregate,
        hash_aggregate_chunked,
    )
    from hash_join_codes_knl_tpu_torch.parallel.cpra import cpra_join
    from hash_join_codes_knl_tpu_torch.parallel.distributed import data_mesh
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

    if args.small:
        I, O = 200_000, 1_600_000
        npj_I, npj_O = 100_000, 400_000
    else:
        I, O = 16_000_000, 256_000_000
        npj_I, npj_O = 4_000_000, 16_000_000

    mesh = data_mesh(device=dev)
    lead = mesh.rank == 0
    info = hb.device_info(dev)
    results = {}

    def want(gate):
        if args.only is None or args.only in gate:
            return True
        return any(args.only in row for row in GATE_ROWS.get(gate, ()))

    def record(name, outer_n, timing, extra=None):
        seconds, reps = timing
        results[name] = {
            "seconds": round(seconds, 6),
            "reps": reps,
            "tuples_per_s": round(outer_n / seconds, 1),
            **(extra or {}),
            "device": info,
        }
        if lead:
            print(f"{name:24s} {seconds:8.4f}s  "
                  f"{outer_n / seconds / 1e6:9.1f} M/s", flush=True)

    def timed(fn, reps=3):
        return hb.sync_run(fn, dev, reps), reps

    def on_dev(*cols):
        return [u32_to_device(c, dev) for c in cols]

    def check(name, got, want_n):
        if got != want_n:
            raise AssertionError(f"{name}: join_tuples {got} != {want_n}")

    need_full = any(want(n) for n in ("phj_uniform", "aggregate",
                                      "npj_uniform_full", "zipf", "cpra"))
    inner = outer = None
    if need_full:
        inner, outer, _ = generate(seed=42, inner_tuples=I, outer_tuples=O,
                                   mode="uniform" if O > I else "ref")
        ik, iv, ok, ov = on_dev(inner.keys, inner.vals, outer.keys,
                                outer.vals)
    want_full = expected_join_tuples(I, O)

    if want("phj_uniform"):
        plan = plan_join(I, O, device=dev)

        def run_phj(rep):
            got = int(phj_join(ik, iv, ok, ov, plan).join_tuples)
            check("phj_uniform", got, want_full)
            return got

        record("phj_uniform", O, timed(run_phj),
               {"window": plan.window or "auto",
                "probe_chunks": plan.probe_chunks, "tile": plan.tile,
                "join_tuples": want_full})

    if want("aggregate"):
        # groups = the probe multiset by key (I distinct groups)
        def run_agg(rep):
            got = int(hash_aggregate(ok, ov)[0])
            check("hash_aggregate", got, I)
            return got

        record(f"hash_aggregate_{O // 10**6}M", O, timed(run_agg, reps=2),
               {"groups": I, "note": "sort-group-reduce, no scatter"})

        # the same rows folded to 64K groups: two-level chunked against
        # single-level, held equal once before either is timed
        def fold(k):
            return (k & ((1 << G_BITS) - 1)) + 1

        def agg2():
            return hash_aggregate_chunked(fold(ok), ov, chunks=64,
                                          partial_cap=1 << 23)

        def agg1():
            return hash_aggregate(fold(ok), ov)

        ng0, gk0, s0, _, ovf0 = agg2()
        g0 = int(ng0)
        ng1, gk1, s1, _ = agg1()
        if int(ovf0) != 0 or int(ng1) != g0 or not (
                torch.equal(gk1[:g0], gk0[:g0])
                and torch.equal(s1[:g0], s0[:g0])):
            raise AssertionError("chunked aggregate differs from the "
                                 "single-level one")
        del ng0, gk0, s0, ng1, gk1, s1

        def run_agg2(rep):
            ng, _, _, _, ovf = agg2()
            if int(ovf) != 0 or int(ng) != g0:
                raise AssertionError("chunked aggregate: overflow or "
                                     "group count changed")
            return g0

        record(f"hash_aggregate_chunked_{O // 10**6}M_64Kgroups", O,
               timed(run_agg2, reps=2),
               {"groups": g0, "chunks": 64,
                "note": "two-level batched-chunk sorts + partial "
                        "re-aggregation; exact vs single-level"})

        def run_agg1(rep):
            got = int(agg1()[0])
            check("hash_aggregate 64K groups", got, g0)
            return got

        record(f"hash_aggregate_{O // 10**6}M_64Kgroups", O,
               timed(run_agg1, reps=2),
               {"groups": g0,
                "note": "single-level baseline for the chunked row"})

    if want("npj_uniform_full"):
        # NPJ (one global table, sorted probe) at the headline shape
        nplan_f = plan_npj(I)
        nwin_f = nplan_f.auto_window(O)

        def run_npj_full(rep):
            tk, tv, _, max_disp = npj_build(ik, iv, nplan_f)
            _, mc, wovf = npj_probe_sorted(tk, tv, ok, nplan_f, max_disp,
                                           nwin_f)
            got = int(mc.sum(dtype=torch.int64))
            if int(wovf):
                raise AssertionError("npj_uniform_full: window overflow")
            check("npj_uniform_full", got, want_full)
            return got

        record("npj_uniform_full", O, timed(run_npj_full, reps=2),
               {"note": f"{I}x{O}: global-table sorted probe, "
                        "BASELINE shape", "window": nwin_f,
                "join_tuples": want_full})

        # the sorted-order output contract (the PHJ merge contract): one
        # probe-side sort, no index carry, no inverse scatter
        def run_npj_sorted(rep):
            tk, tv, _, max_disp = npj_build(ik, iv, nplan_f)
            *_, mc, wovf = npj_probe_sorted(tk, tv, ok, nplan_f, max_disp,
                                            nwin_f, probe_vals=ov,
                                            order="sorted")
            got = int(mc.sum(dtype=torch.int64))
            if int(wovf):
                raise AssertionError("npj sorted order: window overflow")
            check("npj_uniform_full_sorted_order", got, want_full)
            return got

        record("npj_uniform_full_sorted_order", O,
               timed(run_npj_sorted, reps=2),
               {"note": f"{I}x{O}: sorted-aligned output (PHJ merge "
                        "contract) -- one probe-side sort instead of "
                        "two", "window": nwin_f, "join_tuples": want_full})

    if need_full:
        del ok, ov

    if want("zipf"):
        base = plan_join(I, O, device=dev)
        for z in (0.75, 1.0):
            # a per-row --only filter: one z must not pay the other's
            # generation and runs
            if args.only is not None and args.only not in f"phj_zipf_{z}":
                continue
            _, outer_z, _ = generate(seed=43, inner_tuples=I,
                                     outer_tuples=O, mode="zipf", zipf=z)
            okz, ovz = on_dev(outer_z.keys, outer_z.vals)
            res0, zplan = join(ik, iv, okz, ovz, base)
            want_z = match_count(ik, okz)
            check(f"phj_zipf_{z}", int(res0.join_tuples), want_z)
            if args.small:
                # digest against the host oracle (small sizes only: at
                # 256M rows the oracle itself is the bottleneck)
                got_d = multiset_digest(*materialize(res0))
                want_d = multiset_digest(*join_oracle(
                    inner.keys, inner.vals, outer_z.keys, outer_z.vals))
                if got_d != want_d:
                    raise AssertionError(f"zipf z={z} digest mismatch")
            res0 = None
            del outer_z

            def run_zipf(rep, zplan=zplan, okz=okz, ovz=ovz, z=z,
                         want_z=want_z):
                res = phj_join(ik, iv, okz, ovz, zplan)
                if int(res.build_counts[0]) != 0:
                    raise AssertionError(f"zipf z={z}: window overflow")
                got = int(res.join_tuples)
                check(f"phj_zipf_{z}", got, want_z)
                return got

            record(f"phj_zipf_{z}", O, timed(run_zipf),
                   {"window": zplan.window or "auto",
                    "probe_chunks": zplan.probe_chunks, "tile": zplan.tile,
                    "join_tuples": want_z})
            del run_zipf, okz, ovz

    # the 4M x 16M relations of the NPJ, radix and chain rows
    need_npj = want("npj_uniform") or want("radix_4096") or want("npj_chain")
    if need_npj:
        inner_n, outer_n, _ = generate(seed=44, inner_tuples=npj_I,
                                       outer_tuples=npj_O, mode="uniform")
        nik, niv, nok, nov = on_dev(inner_n.keys, inner_n.vals,
                                    outer_n.keys, outer_n.vals)
        del inner_n, outer_n
    want_npj = expected_join_tuples(npj_I, npj_O)

    if want("npj_uniform"):
        nplan = plan_npj(npj_I)
        nwindow = nplan.auto_window(npj_O)

        def run_npj(rep):
            tk, tv, _, max_disp = npj_build(nik, niv, nplan)
            _, mc, wovf = npj_probe_sorted(tk, tv, nok, nplan, max_disp,
                                           nwindow)
            got = int(mc.sum(dtype=torch.int64))
            if int(wovf):
                raise AssertionError("npj_uniform: window overflow")
            check("npj_uniform", got, want_npj)
            return got

        record("npj_uniform", npj_O, timed(run_npj),
               {"note": f"{npj_I}x{npj_O}: global-table sorted probe",
                "window": nwindow, "join_tuples": want_npj})

    if want("radix_4096") and not args.small:
        # the reference CPRA's fixed operating point, NUM_PARTITIONS=4096
        # (cpra2.cpp:2023), as two 6-bit passes through the padded radix
        # engine at the row's 4M x 16M shape
        rplan = JoinPlan(p_bits=12, slots=1024, tile=2048, pass_bits=(6, 6),
                         partition_impl="radix", probe_impl="pallas")

        def run_radix(rep):
            res = phj_join(nik, niv, nok, nov, rplan)
            if int(res.build_counts[-1]) != 0:
                raise AssertionError("radix 4096-way: pass overflow")
            got = int(res.join_tuples)
            check("phj_radix_4096way", got, want_npj)
            return got

        record("phj_radix_4096way", npj_O, timed(run_radix, reps=2),
               {"note": f"{npj_I}x{npj_O}: padded radix engine, "
                        "pass_bits=(6,6) -- the cpra2.cpp:2023 fanout",
                "pass_bits": [6, 6], "join_tuples": want_npj})

    if want("npj_chain"):
        # the chain-walk ablation (+ _UNIQUE first-match retirement,
        # npj.cpp:954-956) at 1/8 probe volume
        nplan = plan_npj(npj_I)
        nok8 = nok[: max(1, npj_O // 8)]
        want8 = match_count(nik, nok8)
        for name, uniq in (("npj_chain", False), ("npj_chain_unique", True)):
            cplan = dataclasses.replace(nplan, unique=uniq,
                                        probe_impl="chain")

            def run_chain(rep, cplan=cplan, name=name):
                tk, tv, _, _ = npj_build(nik, niv, cplan)
                _, mc = npj_probe(tk, tv, nok8, cplan)
                got = int(mc.sum(dtype=torch.int64))
                check(name, got, want8)
                return got

            record(name, len(nok8), timed(run_chain, reps=1),
                   {"note": "chain-walk ablation, 1/8 probe volume",
                    "join_tuples": want8})
        del nok8

    if want("cpra"):
        if need_npj:
            del nik, niv, nok, nov
        # device columns, as the JAX row passes: the row times the join,
        # not an upload of the host relations
        cok, cov = on_dev(outer.keys, outer.vals)

        def run_cpra(rep):
            res, _ = cpra_join(ik, iv, cok, cov, mesh, slack=3.0)
            got = int(mesh.all_sum([int(res.join_tuples)])[0])
            check("cpra", got, want_full)
            return got

        record("cpra", O, timed(run_cpra, reps=1),
               {"devices": mesh.size, "join_tuples": want_full})

    if not lead:
        return 0
    if args.only is not None:
        try:
            with open(args.out) as f:
                merged = json.load(f)
        except (OSError, ValueError):
            merged = {}
        merged.update(results)
        results = merged
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
