"""Weak-scaling efficiency of the PyTorch/CUDA port's distributed join
(the counterpart of scripts/bench_scaling.py; BASELINE: >=70% at 1 rank
-> N).

Scales the CPRA step over 1..N ranks with a FIXED per-rank workload: on
m ranks the relations are m x the one-rank sizes, so perfect scaling
keeps the seconds flat and the efficiency is t(1) / t(m).  Each size
also runs the staged step once per rep, split into the exchange and the
local join.

Ranks:
  - under torchrun over N cards (one process a card, NCCL): each mesh
    size m is a Mesh over dist.new_group(range(m)) (the whole world at
    m = N); the ranks outside it wait at a barrier;
  - otherwise (one card, or --device cpu): m gloo ranks as threads of
    this process sharing the one device (thread_meshes), m up to
    --ranks.  They share one device, so their raw t(1)/t(m) trends to
    1/m on the card (to cores/m on the CPU) by construction; the
    serialization-corrected efficiency, (m / min(m, units)) * t(1) /
    t(m) with units the CPU's cores or the one card, is reported beside
    it, as bench_scaling.py does on its CPU mesh.

Every size is exact (join_tuples against the generator's count).  Rank 0
writes scaling_results_torch.json and prints one line per mesh size.

Usage: python scripts/torch_bench_scaling.py [--inner N] [--outer N]
       [--reps 3] [--ranks 8] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hash_join_codes_knl_tpu_torch.utils import bench as hb  # noqa: E402


def _meshes(m: int, dev, world: int):
    """This process's ranks of an m-rank mesh: under torchrun the one
    Mesh over the first m ranks (None outside it), else m thread ranks."""
    import torch.distributed as dist

    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        Mesh,
        thread_meshes,
    )

    if world == 1:
        return thread_meshes(m, dev)
    group = dist.group.WORLD if m == world else dist.new_group(
        list(range(m)))
    rank = dist.get_rank()
    if rank >= m:
        return []
    return [Mesh(group, rank, m, dev, backend=dist.get_backend())]


def _one_size(mesh, cols, plan, inner_cap, outer_cap, reps, dev):
    """On one rank: (median fenced seconds of the fused step, join
    tuples over the mesh, median exchange and local-join seconds of the
    staged step)."""
    from hash_join_codes_knl_tpu_torch.parallel.cpra import (
        make_cpra_step,
        make_cpra_steps_staged,
    )
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        shard_null_padded,
    )
    from hash_join_codes_knl_tpu_torch.utils.timing import PhaseTimer

    args = [shard_null_padded(c, mesh) for c in cols]
    step = make_cpra_step(mesh, plan, inner_cap, outer_cap)
    got = []

    def run():
        res, _, diag = step(*args)
        if int(diag[0]) or int(diag[1]):
            raise AssertionError(f"overflow on {mesh.size} ranks: exchange "
                                 f"{int(diag[0])}, window {int(diag[1])}")
        got.append(int(mesh.all_sum([int(res.join_tuples)])[0]))

    run()  # warm-up
    ts = []
    for _ in range(reps):
        mesh.barrier()
        ts.append(hb.fenced_seconds(run, dev))
    # the fused step's seconds are the slowest rank's
    sec = float(mesh.all_max([int(1e9 * float(np.median(ts)))])[0]) / 1e9
    exch_fn, join_fn = make_cpra_steps_staged(mesh, plan, inner_cap,
                                              outer_cap)
    stage = {"exchange": [], "local_join": []}
    for r in range(reps + 1):
        timer = PhaseTimer()
        mesh.barrier()
        *ex, eovf = timer.run("exchange", exch_fn, *args)
        _, jovf = timer.run("local_join", join_fn, *ex)
        if eovf or jovf:
            raise AssertionError(f"staged overflow on {mesh.size} ranks")
        if r:  # the first pass is the warm-up
            for k in stage:
                stage[k].append(timer.phases[k])
    return sec, got[-1], {k: round(float(np.median(v)), 6)
                          for k, v in stage.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inner", type=int, default=None,
                    help="per-rank build tuples (default 200K; 50K on the "
                         "CPU)")
    ap.add_argument("--outer", type=int, default=None,
                    help="per-rank probe tuples (default 1.6M; 400K on "
                         "the CPU)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=8,
                    help="largest thread-rank mesh without torchrun")
    ap.add_argument("--out", default="scaling_results_torch.json")
    hb.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = hb.entry_device(args.device)
    cpu = dev.type == "cpu"
    if not cpu:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if args.inner is None:
        args.inner = 50_000 if cpu else 200_000
    if args.outer is None:
        args.outer = 400_000 if cpu else 1_600_000

    import torch.distributed as dist

    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        process_group,
    )

    with process_group(device=dev):
        world = dist.get_world_size() if dist.is_initialized() else 1
        return _scale(args, dev, world)


def _scale(args, dev, world: int) -> int:
    import torch.distributed as dist

    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.parallel.distributed import run_ranks
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate

    lead = world == 1 or dist.get_rank() == 0
    top = world if world > 1 else args.ranks
    # thread ranks share one device: the CPU's cores, or the one card
    units = (os.cpu_count() or 1) if dev.type == "cpu" else 1
    if world > 1:
        units = world
    sizes = [m for m in (1, 2, 4, 8, 16, 32) if m <= top]
    info = hb.device_info(dev)
    results = {}
    t1 = None
    for m in sizes:
        I, O = args.inner * m, args.outer * m
        inner, outer, _ = generate(seed=42, inner_tuples=I, outer_tuples=O,
                                   mode="uniform" if O > I else "ref")
        cols = (inner.keys, inner.vals, outer.keys, outer.vals)
        plan = plan_join(args.inner, args.outer, device=dev)
        inner_cap = max(64, int(4 * I / (m * m)))
        outer_cap = max(plan.tile, int(4 * O / (m * m)))
        meshes = _meshes(m, dev, world)
        outs = run_ranks(meshes, lambda mesh: _one_size(
            mesh, cols, plan, inner_cap, outer_cap, args.reps, dev))
        if world > 1:
            dist.barrier()
        if not outs:
            continue  # a rank outside this mesh
        sec, jt, stages = outs[0]
        want = expected_join_tuples(I, O)
        if jt != want:
            raise AssertionError(f"{m} ranks: join_tuples {jt} != {want}")
        if t1 is None:
            t1 = sec
        eff = t1 / sec
        # ranks beyond the shared units time-slice: perfect weak scaling
        # there costs t1 * m / units, not t1; with m <= units no
        # correction applies
        eff_corr = min(1.0, (m / min(m, units)) * t1 / sec)
        results[str(m)] = {
            "devices": m,
            "outer_tuples": O,
            "seconds": round(sec, 6),
            "rows_per_s": round(O / sec, 1),
            "weak_scaling_efficiency": round(eff, 4),
            "serialization_corrected_efficiency": round(eff_corr, 4),
            "join_tuples": jt,
            "stage_seconds": stages,
        }
        if lead:
            print(f"mesh={m:3d}  {sec:8.4f}s  {O / sec / 1e6:8.2f} M rows/s"
                  f"  eff={eff:.2%}  corrected={eff_corr:.2%}", flush=True)
    if not lead:
        return 0
    results["_device"] = info
    results["_ranks"] = ("torchrun, one process a device" if world > 1
                         else f"{sizes[-1]} gloo thread ranks sharing one "
                              f"{dev.type} device")
    if world == 1 and sizes[-1] > units:
        results["_note"] = (
            f"thread ranks on {units} shared unit(s) ({dev.type}): m > "
            f"{units} ranks time-slice, so raw efficiency is bounded by "
            f"{units}/m; serialization_corrected_efficiency multiplies by "
            "m/min(m, units) to remove exactly that bound (no correction "
            "while m <= units).")
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
