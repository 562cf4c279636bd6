"""Headline benchmark of the PyTorch/CUDA port: PHJ join throughput on the
BASELINE workload (the counterpart of bench.py).

Workload: 16M build x 256M probe uniform u32 relations from the
reference generator (``generate(seed=42)``), ``plan_join`` (the plan-time
chunk-count tuner included), a checked warm-up, then the median of
HJK_BENCH_REPS timed ``phj_join`` runs, each between two
``torch.cuda.synchronize()`` calls.  Metric: probe tuples per second on
one card.  vs_baseline compares against the reference suite's best
published number: PHJ at ~4.4 s on 200M x 200M on a 64-core KNL in cache
mode == ~45.45M probe-tuples/s (README.md:17, BASELINE.md), a CPU figure.

The floors' anchors are the card's own, measured in this process or by
the tuner on this card (``engine/tune.cached_sort_seconds``: the tuner
cache's time, .hjk_tune_torch.json, else timed here):
  - probe sort: the time of this plan's chunk count;
  - build sort: the (key, value) sort of the build side, timed here;
  - output: 16 bytes a probe row over the card's peak memory rate
    (utils/roofline.py);
  - the achievable floor's probe sort: the least time among this plan's
    chunk count, the tuner's candidates and C=2048 (bench.py's static
    anchor), so the achievable floor never exceeds the feasible one.

Prints exactly one JSON line: bench.py's keys plus ``device`` (the card's
name and power limit as nvidia-smi gives them).  A wrong cardinality
prints an ``error`` line and exits 1.  Scale can be overridden with
HJK_BENCH_INNER/HJK_BENCH_OUTER (tuple counts) and HJK_BENCH_REPS.

    python bench_torch.py [--device cpu]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

from hash_join_codes_knl_tpu_torch.utils import bench as hb

BASELINE_TUPLES_PER_S = 200_000_000 / 4.4  # reference best (PHJ, KNL cache)
ACHIEVABLE_CHUNKS = 2048  # bench.py's achievable-floor chunk count


def _build_sort_anchor(ik, iv, plan, dev, reps: int = 2) -> tuple[float, str]:
    """Seconds of the build side's (key, value) sort at its padded size
    (engine/phj.py _merge_sort_side), the least of `reps` fenced runs
    after a warm-up."""
    from hash_join_codes_knl_tpu_torch.engine.phj import _merge_sort_side

    pad = -(-ik.shape[0] // 128) * 128
    run = lambda: _merge_sort_side(ik, iv, pad, plan.factor)  # noqa: E731
    run()
    return (min(hb.fenced_seconds(run, dev) for _ in range(reps)),
            f"measured-in-process:min-of-{reps}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    hb.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = hb.entry_device(args.device)
    inner_n = int(os.environ.get("HJK_BENCH_INNER", 16_000_000))
    outer_n = int(os.environ.get("HJK_BENCH_OUTER", 256_000_000))
    reps = int(os.environ.get("HJK_BENCH_REPS", 5))

    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.phj import phj_join
    from hash_join_codes_knl_tpu_torch.engine.tune import (
        DEFAULT_CANDIDATES,
        cached_sort_seconds,
    )
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device
    from hash_join_codes_knl_tpu_torch.utils.roofline import (
        hbm_peak_bytes_per_s,
    )

    mode = "ref" if outer_n <= inner_n else "uniform"
    inner, outer, _ = generate(seed=42, inner_tuples=inner_n,
                               outer_tuples=outer_n, mode=mode)
    plan = plan_join(inner_n, outer_n, device=dev)
    ik, iv, ok, ov = (u32_to_device(c, dev) for c in
                      (inner.keys, inner.vals, outer.keys, outer.vals))
    del inner, outer

    def run():
        return int(phj_join(ik, iv, ok, ov, plan).join_tuples)

    got = run()  # warm-up, checked
    want = expected_join_tuples(inner_n, outer_n)
    if got != want:
        print(json.dumps({
            "metric": "phj_join_throughput",
            "value": 0.0,
            "unit": "probe-tuples/s/chip",
            "vs_baseline": 0.0,
            "error": f"wrong cardinality: got {got} want {want}",
        }))
        sys.exit(1)
    dt = float(np.median([hb.fenced_seconds(run, dev)
                          for _ in range(reps)]))
    tput = outer_n / dt

    # roofline context: the least device-memory traffic any
    # implementation of the full join must move (read both relations
    # once, write the aligned output once) against the card's peak rate
    peak, _ = hbm_peak_bytes_per_s(dev)
    floor_bytes = 8 * (inner_n + outer_n) + 16 * outer_n
    pct_floor = 100 * floor_bytes / dt / peak

    # the floors of a sort-based engine, on this card's own anchors: the
    # feasible floor is this plan's probe sort + the build sort + the
    # output write; the achievable floor takes the cheapest probe sort
    # among the chunk counts timed (a lower bound over those, not an
    # operating point: C=2048's tiles fit no window)
    build_s, build_src = _build_sort_anchor(ik, iv, plan, dev)
    del ik, iv, ok, ov
    out_s = outer_n * 16 / peak
    C = max(1, plan.probe_chunks)
    sorts = {c: cached_sort_seconds(outer_n, plan.tile, c, dev)
             for c in dict.fromkeys((C, *DEFAULT_CANDIDATES,
                                     ACHIEVABLE_CHUNKS))}
    probe_s, probe_src = sorts[C]
    c_lo = min(sorts, key=lambda c: sorts[c][0])
    c_lo_s, c_lo_src = sorts[c_lo]
    feasible_s = probe_s + build_s + out_s
    achievable_s = c_lo_s + build_s + out_s
    print(json.dumps({
        "metric": f"phj_join_throughput_{inner_n//10**6}Mx"
                  f"{outer_n//10**6}M",
        "value": round(tput, 1),
        "unit": "probe-tuples/s/chip",
        "vs_baseline": round(tput / BASELINE_TUPLES_PER_S, 3),
        "seconds": round(dt, 6),
        "join_tuples": got,
        "pct_hbm_stream_floor": round(pct_floor, 2),
        "pct_achievable_floor": round(100 * achievable_s / dt, 1),
        "pct_feasible_floor": round(100 * feasible_s / dt, 1),
        "anchors": {
            "probe_sort_s": round(probe_s, 6),
            "probe_sort_src": probe_src,
            "build_sort_s": round(build_s, 6),
            "build_sort_src": build_src,
            "out_gbps": round(peak / 1e9, 1),
            "feasible_floor_s": round(feasible_s, 6),
            "achievable_probe_sort_s": round(c_lo_s, 6),
            "achievable_probe_sort_src": f"C={c_lo}: {c_lo_src}",
            "probe_sort_s_by_chunks": {str(c): round(t, 6)
                                       for c, (t, _) in sorts.items()},
        },
        "plan": {"tile": plan.tile, "probe_chunks": plan.probe_chunks,
                 "p_bits": plan.p_bits},
        "device": hb.device_info(dev),
    }))


if __name__ == "__main__":
    main()
