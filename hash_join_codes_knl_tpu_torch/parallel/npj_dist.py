"""Distributed NPJ: the shared-global-table join over ranks.

Counterpart of ``hash_join_codes_knl_tpu/parallel/npj_dist.py``.  The
reference NPJ (npj.cpp:769-927) has every thread build into one shared
open-addressing table, then probe its own outer slice against it.  Here
"one table all workers reach" is a table replicated per rank: the ranks
all-gather the build side, each builds the identical table (the build
is deterministic and independent of insertion order, engine/npj.py),
and each probes only its own outer block, with no communication during
the probe -- the reference's phase structure (a fenced build phase,
then an embarrassingly parallel probe phase, npj.cpp:861-897).

The degenerate baseline by design: the build work is repeated on every
rank and the table occupies every device.  It wins only for a small
build side; PHJ and CPRA own every other regime.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.npj import (
    NpjPlan,
    npj_build,
    npj_probe,
    npj_probe_sorted,
    plan_npj,
)
from ..utils.hashing import to_numpy_u32
from .distributed import Mesh, require_live_mesh, shard_null_padded


def make_npj_step(mesh: Mesh, plan: NpjPlan, probe_window: int = 0):
    """The distributed NPJ step: fn(ik, iv, ok, ov) over this rank's
    blocks -> (match values and counts aligned to the local outer block,
    join_tuples, build_overflow, window_overflow), the last three summed
    over the ranks.  The two overflows stay separate: a table-margin
    overflow is fixed only by re-sizing the table, a window overflow by
    widening the window."""

    def step(ik, iv, ok, ov):
        # build phase: replicate the build side (the shared table) and
        # build the identical table on every rank
        tk, tv, bovf, max_disp = npj_build(mesh.all_gather(ik),
                                           mesh.all_gather(iv), plan)
        # probe phase: the local outer block only, no communication
        if plan.probe_impl == "chain":
            mv, mc = npj_probe(tk, tv, ok, plan)
            wovf = 0
        else:
            window = probe_window or plan.window or plan.auto_window(
                ok.shape[0])
            mv, mc, wovf = npj_probe_sorted(tk, tv, ok, plan, max_disp,
                                            window)
        total, bovf, wovf = mesh.all_sum([int(mc.sum(dtype=torch.int64)),
                                          int(bovf), int(wovf)]).tolist()
        return mv, mc, total, bovf, wovf

    return step


def npj_join_dist(inner_keys, inner_vals, outer_keys, outer_vals,
                  mesh: Mesh, plan: NpjPlan | None = None,
                  liveness_timeout_s: float | None = 30.0):
    """Front end, called by every rank with the same replicated host
    relations; runs on mesh.device.  Returns (match_vals, match_cnts,
    join_tuples, plan): the match columns aligned to the whole outer
    relation (host uint32 and int32, gathered once, the same on every
    rank) and the total cardinality.  A window overflow re-plans as
    npj_join does; a build overflow raises."""
    require_live_mesh(mesh, liveness_timeout_s, stage="npj_build")
    if plan is None:
        plan = plan_npj(len(inner_keys))
    # pads land at the tail of the last block, so trimming the gathered
    # outputs to the input length drops exactly them
    args = [shard_null_padded(c, mesh) for c in
            (inner_keys, inner_vals, outer_keys, outer_vals)]
    local_n = len(outer_keys) // mesh.size
    window = plan.window or plan.auto_window(local_n)
    size_cap = min(plan.table_size, plan.max_window)
    for _ in range(4):  # sorted-probe window re-planning, as in npj_join
        step = make_npj_step(mesh, plan, probe_window=window)
        mv, mc, total, bovf, wovf = step(*args)
        if bovf > 0:
            raise RuntimeError(
                f"NPJ build overflow: {bovf} tuples past the table margin; "
                "increase NpjPlan.margin or lower the load factor"
            )
        if wovf == 0 or plan.probe_impl == "chain" or window >= size_cap:
            break
        # an undersized explicit window jumps to the auto estimate, then
        # doubles: plain doubling from a tuned window could spend every
        # retry below what the auto formula picks first
        window = min(max(2 * window, plan.auto_window(local_n)), size_cap)
    if wovf > 0:
        raise RuntimeError(
            "NPJ sorted-probe window overflow persists at the widest "
            "window; use the PHJ merge engine for this shape"
        )
    n_out = len(outer_keys)
    mv_all = to_numpy_u32(mesh.all_gather(mv))[:n_out]
    mc_all = mesh.all_gather(mc).cpu().numpy().astype(np.int32)[:n_out]
    return mv_all, mc_all, int(total), plan
