"""Distributed Grace join: both relations larger than the mesh's memory.

Counterpart of ``hash_join_codes_knl_tpu/parallel/grace_dist.py``.  The
single-device Grace driver (engine/grace.py) removes both size limits on
one card; this one spreads it over the ranks of a mesh, the composition
BASELINE config 5 (1B x 4B rows) asks for: the reference's fixed
decomposition and cross-thread memcpy re-aggregation
(cpra2.cpp:1757-1906) with the thread axis replaced by the chunk stream
(out of core) and the ranks (scale-out).  Every rank passes the same
host relations (numpy or np.memmap), as every process of the JAX
package's multi-process run does.

1. **Distributed partition pass.**  Each superchunk of size x
   chunk_rows host rows is split over the ranks; every rank scrambles
   its block (K1) and runs one pass of the radix kernel at fanout F =
   2^f_bits.  The pass emits partition-contiguous regions in order of
   the top hash bits and the owner rank of partition p is its top
   log2(size) bits, so one all-to-all of the flat regions is the owner
   exchange: rank d receives partitions [d*F/size, (d+1)*F/size) from
   every peer, with no re-pack.  The received rows, compacted on the
   card, append to the rank's partition files (engine/spill.py's raw
   u32 format).  A superchunk whose pass still overflows after the
   capacity retries is dominated by a hot key and is split exactly on
   the host, every rank keeping its own partitions.
2. **Partition-parallel joins.**  Round r joins partition d*F/size + r
   on rank d: its columns load from the rank's files and pad to one
   shared (build, probe) capacity, and the merge engine joins them.  A
   window overflow anywhere re-plans every rank in lockstep from the
   all-reduced span (engine/phj.py replan_from_span).

With more than one rank each rank spills under spill_dir/host<rank>,
with its own sidecars and journal, and holds exactly the partitions it
owns -- the JAX package's multi-process layout.  Global facts (partition
counts, resume decisions, journal maps, join totals) are all-reduced.
A side resumes its spill only when every rank can (else all recompute
it together), and a corrupt spill raises: recomputing it would run the
side's collectives on one rank alone.  A world of one rank writes
spill_dir itself, interchangeable with grace_join's files of either
package, and recomputes a corrupt reused side once, as grace_join does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..engine.config import JoinPlan, plan_join
from ..engine.grace import (
    GraceResult,
    PartitionMeta,
    _append_fragments,
    _budget_caps_local,
    _host_partition_fragments,
    _init_partition_files,
    _journal_append,
    _make_loader,
    _phase1,
    _phase2_journal,
    _side_fingerprint,
    _side_sidecar,
    _try_resume_side,
    _write_side_sidecar,
)
from ..engine.phj import (
    _scrambled,
    downgrade_plan_opts,
    phj_join,
    replan_from_span,
)
from ..engine.stream import _Staging
from ..ops.radix_partition import radix_partition
from ..utils.hashing import (
    BIAS,
    mod_inverse_u32,
    np_hashed_key,
    to_numpy_u32,
    u32_to_device,
    unbias,
)
from .cpra import (
    _engine_overflow,
    _engine_select_overflow,
    _engine_span,
    _owner_bits,
)
from .distributed import Mesh, require_live_mesh


def _host_spill_dir(spill_dir: str, mesh: Mesh) -> str:
    """spill_dir itself for a world of one (interchangeable with
    grace_join's spills), spill_dir/host<rank> otherwise: on a real pod
    these are different filesystems, and on a shared one the
    subdirectories keep the ranks' files apart."""
    if mesh.size == 1:
        return spill_dir
    d = os.path.join(spill_dir, f"host{mesh.rank}")
    os.makedirs(d, exist_ok=True)
    return d


def _received_fragments(rk, rv, rc, mesh: Mesh, Fl: int, F: int):
    """This rank's received regions (size sources x Fl partitions x
    capr slots) compacted on the card, live rows only, as host
    fragments: [(scrambled uint32 keys, values)] for every partition, the
    partitions of other ranks empty.  The exact counts split the rows."""
    W = mesh.size
    order = lambda t: t.view(W, Fl, -1).transpose(0, 1).reshape(-1)
    kb, vb = order(rk), order(rv)
    live = kb != BIAS
    keys = to_numpy_u32(unbias(kb[live]))
    vals = to_numpy_u32(vb[live])
    counts = rc.view(W, Fl).sum(0, dtype=torch.int64).cpu().numpy()
    if int(counts.sum()) != len(keys):
        raise RuntimeError(f"radix pass counts {int(counts.sum())} live "
                           f"rows, its regions hold {len(keys)}")
    empty = np.zeros(0, np.uint32)
    frags = [(empty, empty)] * F
    ends = np.cumsum(counts)
    for j, (e, c) in enumerate(zip(ends.tolist(), counts.tolist())):
        frags[mesh.rank * Fl + j] = (keys[e - c : e], vals[e - c : e])
    return frags


def _partition_side_dist(keys, vals, factor: int, f_bits: int,
                         chunk_rows: int, d: str, side: str, mesh: Mesh,
                         fp: dict | None = None, cap_retries: int = 3):
    """Stream one relation through the ranks' radix passes and the owner
    all-to-all; append this rank's received fragments to its partition
    files ``{side}_{p}_{hk,val}.bin`` in `d`.  Same sidecar contract as
    engine/grace.py (the spill formats are interchangeable).  chunk_rows
    is rows per rank per superchunk.  The counts and checksums are this
    rank's (zero for the partitions it does not own).  Returns (counts,
    hk checksums, val checksums, superchunks split on the host)."""
    W, F = mesh.size, 1 << f_bits
    Fl = F // W
    n = len(keys)
    counts = np.zeros(F, np.int64)
    hk_csums = [0] * F
    val_csums = [0] * F
    host_chunks = 0
    owned = range(mesh.rank * Fl, (mesh.rank + 1) * Fl)
    if fp is None:
        fp = _side_fingerprint(keys, vals, factor, f_bits)
    _init_partition_files(d, side, F)
    # a relation smaller than one superchunk takes a smaller block (the
    # files' content does not depend on the chunking)
    chunk_rows = max(1, min(chunk_rows, -(-n // W)))
    super_rows = W * chunk_rows
    for pos in range(0, n, super_rows):
        lo = min(n, pos + mesh.rank * chunk_rows)
        hi = min(n, lo + chunk_rows)
        ck = np.zeros(chunk_rows, np.uint32)
        cv = np.zeros(chunk_rows, np.uint32)
        ck[: hi - lo] = np.asarray(keys[lo:hi])
        cv[: hi - lo] = np.asarray(vals[lo:hi])
        # null-key pads in the tail superchunk are dropped by the pass
        hk, v = _scrambled(u32_to_device(ck, mesh.device),
                           u32_to_device(cv, mesh.device), factor)
        cap = 0  # the pass's own estimate first
        for _ in range(cap_retries + 1):
            bk, bv, cnts, ovf = radix_partition(hk, v, f_bits, cap=cap)
            if not mesh.all_sum([int(ovf != 0)])[0]:
                break
            # overflow is a value: every rank retries, doubled capacity
            cap = 2 * (bk.shape[0] // F)
        else:
            # a persistent overflow is the pass's per-tile run bound (one
            # hot key dominating a block), which capacity never fixes:
            # split the superchunk exactly on the host.  Every rank
            # computes the whole split and keeps its own partitions; the
            # files' content, a multiset, is the same either way
            sk = np.zeros(super_rows, np.uint32)
            sv = np.zeros(super_rows, np.uint32)
            take = min(super_rows, n - pos)
            sk[:take] = np.asarray(keys[pos : pos + take])
            sv[:take] = np.asarray(vals[pos : pos + take])
            frags, _ = _host_partition_fragments(np_hashed_key(sk, factor),
                                                 sv, f_bits)
            frags = [f if p in owned else (f[0][:0], f[1][:0])
                     for p, f in enumerate(frags)]
            _append_fragments(d, side, frags, counts, hk_csums, val_csums)
            host_chunks += 1
            continue
        frags = _received_fragments(mesh.all_to_all(bk), mesh.all_to_all(bv),
                                    mesh.all_to_all(cnts), mesh, Fl, F)
        del bk, bv, hk, v
        _append_fragments(d, side, frags, counts, hk_csums, val_csums)
    _write_side_sidecar(d, side, fp, counts, hk_csums, val_csums)
    return counts, hk_csums, val_csums, host_chunks


def _agree_resume(spill: str, sides: dict, factor: int, f_bits: int,
                  mesh: Mesh) -> None:
    """Resume agreement: phase 1 runs collectives, so every rank resumes
    a side or every rank recomputes it together (a lone recomputing rank
    would deadlock the rest).  A rank that could resume but was outvoted
    drops its sidecar, so that _phase1 recomputes on all ranks."""
    for side, (k, v) in sides.items():
        fp = _side_fingerprint(k, v, factor, f_bits)
        can = _try_resume_side(spill, side, fp) is not None
        if mesh.all_sum([int(can)])[0] != mesh.size and can:
            os.remove(_side_sidecar(spill, side))


def _lockstep_join(cols, local: JoinPlan, mesh: Mesh, r: int,
                   window_retries: int, after_dispatch):
    """One round's join on every rank, re-planned in lockstep from the
    all-reduced diag [engine overflow, max span, plan-opt violations];
    after_dispatch() runs once, while the first attempt is in flight.
    Returns (result, final local plan, diag)."""
    for attempt in range(window_retries + 1):
        res = phj_join(*cols, local)
        if attempt == 0:
            after_dispatch()
        ovf, sel = mesh.all_sum([int(_engine_overflow(res, local)),
                                 int(_engine_select_overflow(res, local))])
        span = int(mesh.all_max([int(_engine_span(res, local))])[0])
        diag = (int(ovf), span, int(sel))
        if not local.probe_impl.startswith("merge") or diag[0] == 0:
            return res, local, diag
        res = None
        if attempt == window_retries:
            break
        if sel:
            local = downgrade_plan_opts(local)
        if diag[0] > sel:
            local = replan_from_span(local, span)
    raise RuntimeError(f"round {r}: window overflow persists across "
                       "re-plans")


def grace_join_dist(
    inner_keys,
    inner_vals,
    outer_keys,
    outer_vals,
    mesh: Mesh,
    f_bits: int = 6,
    chunk_rows: int = 16_000_000,
    spill_dir: str | None = None,
    plan: JoinPlan | None = None,
    partition_budget_rows: int = 220_000_000,
    on_partition=None,
    window_retries: int = 3,
    liveness_timeout_s: float | None = 30.0,
) -> GraceResult:
    """Join two host-resident relations over the ranks of `mesh`; neither
    needs to fit the mesh's combined device memory.  Every rank passes
    the same four inputs (numpy uint32 arrays or np.memmap); chunk_rows
    is rows per rank per phase-1 superchunk; runs on mesh.device.

    on_partition(meta, res, raw_probe_keys) is called on the owner rank
    of each partition with its JoinResult (device columns, probe keys
    still scrambled, build_counts the all-reduced [window overflow, max
    span, plan-opt violations]) and the probe keys unscrambled as host
    uint32.  Needs f_bits >= log2(size) (every rank owns a partition).
    The counts and totals of the returned GraceResult are global and the
    same on every rank."""
    if spill_dir is None:
        raise ValueError("grace_join_dist needs spill_dir")
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    W = mesh.size
    dev_bits = _owner_bits(W)
    if f_bits < dev_bits:
        raise ValueError(
            f"f_bits={f_bits} < log2(ranks)={dev_bits}: every rank must "
            "own at least one partition"
        )
    os.makedirs(spill_dir, exist_ok=True)
    spill = _host_spill_dir(spill_dir, mesh)
    F = 1 << f_bits
    Fl = F // W
    if plan is None:
        # per-pair planning happens below; this fixes the scramble factor
        plan = mesh.root_call(plan_join, max(1, len(inner_keys) >> f_bits),
                              max(1, len(outer_keys) >> f_bits),
                              device=mesh.device)
    # stage boundary: fail fast instead of hanging in the exchange
    require_live_mesh(mesh, liveness_timeout_s, stage="grace_dist_partition")
    t0 = time.perf_counter()
    sides = {"build": (inner_keys, inner_vals),
             "probe": (outer_keys, outer_vals)}
    if W > 1:
        _agree_resume(spill, sides, plan.factor, f_bits, mesh)
    skew = {}

    def partition_side(k, v, side, fp):
        *state, skew[side] = _partition_side_dist(
            k, v, plan.factor, f_bits, chunk_rows, spill, side, mesh, fp)
        return tuple(state)

    side_state, reused, side_fps, compute_side = _phase1(
        sides, spill, plan.factor, f_bits, partition_side)
    t1 = time.perf_counter()
    # per-rank counts are partition-disjoint; the global view is the sum
    b_counts = mesh.all_sum(side_state["build"][0])
    p_counts = mesh.all_sum(side_state["probe"][0])
    nb_cap, np_cap, local = mesh.root_call(
        _budget_caps_local, b_counts, p_counts, partition_budget_rows,
        f_bits, plan, mesh.device)
    if W > 1:
        # recomputing one rank's corrupt spill would run the side's
        # collectives on that rank alone: refuse, and let the whole job
        # re-run phase 1 together
        def compute_side(side):  # noqa: F811 -- deliberate override
            raise RuntimeError(
                f"rank {mesh.rank}: spilled {side} files are corrupt; a "
                "multi-rank run cannot recompute one rank's phase 1 alone "
                "-- delete this rank's spill dir and re-run the job"
            )

    load_side = _make_loader(spill, side_state, reused, compute_side)
    metas = [PartitionMeta(p, int(b_counts[p]), int(p_counts[p]), 0)
             for p in range(F)]
    jt_local = np.zeros(F, np.int64)
    require_live_mesh(mesh, liveness_timeout_s, stage="grace_dist_join")

    def worked(p):
        return bool(b_counts[p]) and bool(p_counts[p])

    # phase-2 resume (the journal is grace_join's): a round is skipped
    # when every worked pair in it is recorded for these inputs and
    # routing.  The ranks' journals are merged (ownership is disjoint),
    # so every rank skips the same rounds
    done_local = _phase2_journal(spill, side_fps, on_partition)
    present = np.zeros(F, np.int64)
    jts = np.zeros(F, np.int64)
    for p, jt in done_local.items():
        present[p], jts[p] = 1, jt
    present, jts = mesh.all_sum(present), mesh.all_sum(jts)
    done = {p: int(jts[p]) for p in range(F) if present[p]}
    resumed = 0
    live_rounds = []
    for r in range(Fl):
        parts = [q * Fl + r for q in range(W) if worked(q * Fl + r)]
        if not parts:
            continue
        if all(p in done for p in parts):
            for p in parts:
                # the owner rank carries the resumed count into the sum
                jt_local[p] = done[p] if p in done_local else 0
                resumed += 1
        else:
            live_rounds.append(r)
    inv = mod_inverse_u32(plan.factor)
    caps = [nb_cap, nb_cap, np_cap, np_cap]
    with _Staging(mesh.device, caps) as staging:

        def load_pair(idx):
            """(staging handle, None), or (None, the load's error): a
            rank's failed load is agreed on before the round's
            collectives, so that no rank waits in them for it."""
            if idx >= len(live_rounds):
                return None, None
            p = mesh.rank * Fl + live_rounds[idx]
            # a pair empty on either side contributes only null pads
            nb = int(b_counts[p]) if p_counts[p] else 0
            npr = int(p_counts[p]) if b_counts[p] else 0
            try:
                return staging.upload([*load_side("build", p, nb),
                                       *load_side("probe", p, npr)],
                                      caps), None
            except (OSError, ValueError, RuntimeError) as e:
                return None, e

        pending = [load_pair(0)]
        for idx, r in enumerate(live_rounds):
            handle, err = pending.pop()
            if mesh.all_sum([int(err is not None)])[0]:
                raise err or RuntimeError(
                    f"round {r}: another rank failed to load its "
                    "partition pair; the job stops on every rank")
            cols = staging.take(handle)
            # the next round's disk read and copy overlap this join
            res, local, diag = _lockstep_join(
                cols, local, mesh, r, window_retries,
                lambda: pending.append(load_pair(idx + 1)))
            staging.release(handle)
            p = mesh.rank * Fl + r
            jt = int(res.join_tuples)
            jt_local[p] = metas[p].join_tuples = jt
            if not worked(p):
                continue
            _journal_append(spill, p, jt)
            if on_partition:
                raw_pk = (to_numpy_u32(res.probe_keys).astype(np.uint64)
                          * inv % (1 << 32)).astype(np.uint32)
                res.build_counts = torch.tensor(
                    [diag[0] - diag[2], diag[1], diag[2]], dtype=torch.int32)
                on_partition(metas[p], res, raw_pk)
    t2 = time.perf_counter()
    jt_global = mesh.all_sum(jt_local)
    for p in range(F):
        metas[p].join_tuples = int(jt_global[p])
    host_chunks = int(mesh.all_sum([sum(skew.values())])[0])
    return GraceResult(int(jt_global.sum()), metas, f_bits,
                       reused_sides=dict(reused), resumed_partitions=resumed,
                       host_skew_chunks=host_chunks,
                       seconds={"partition": t1 - t0, "join": t2 - t1})
