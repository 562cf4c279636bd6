"""Grace join: both relations larger than device memory, on one card.

Counterpart of ``hash_join_codes_knl_tpu/engine/grace.py``.  The
streaming driver (engine/stream.py) still needs the build side on the
card; this one does not.  Two phases:

1. **Partition.**  Each relation streams through the card in chunks of
   ``chunk_rows`` (double-buffered, engine/stream.py ``_Staging``): K1
   scrambles the keys, one radix pass (ops/radix_partition.py, the
   kernel ``csrc/radix_partition.cu``) splits the chunk by the top
   ``f_bits`` of the scrambled key, the live rows are compacted on the
   card (the counts are exact, so only live rows come back to the host)
   and appended to per-partition files in engine/spill.py's raw-u32
   format.  A chunk whose pass still overflows after ``cap_retries``
   doublings of its region capacity is dominated by a hot key: the
   pass's per-tile run bound (``mrr``, kept from the TPU kernel for
   parity) can never fit it, and the chunk is partitioned exactly on the
   host (``_host_partition_fragments``, the reference's own path),
   counted in ``GraceResult.host_skew_chunks``.
2. **Join.**  Each partition pair fits the card by construction, up to
   skew; the merge engine joins it (engine/phj.py ``phj_join``).  The
   keys are already scrambled, so the local plan has factor 1: K1's
   scramble is the identity and the null convention carries over (the
   biased key is BIAS if and only if the key is 0).  Every pair pads to
   one (build, probe) capacity, as the JAX package pads it, so plans
   and re-plans agree.  The next pair's disk read, checksum and copy to
   the card are issued after the current join is dispatched, and
   overlap it.

Files and resume are the JAX package's, byte for byte in layout and
equal as multisets in content (a partition file's row order follows the
pass, and the checksums are order-free u64 sums): partition files
written by either package are reused by the other.  Phase 1 writes a
sidecar per side with the input fingerprint (rows, key and value
checksums, factor, f_bits) and per-partition counts and checksums; a
rerun over the same inputs reuses the files, every partition read in
phase 2 verifies its checksums, and a corrupt file recomputes that
side's pass once.  Phase 2 appends each joined partition to a journal
(``join_progress.jsonl``), so a rerun joins only the unjournaled rest;
an ``on_partition`` consumer disables that (it must see every
partition), while the journal is still written.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from ..ops.radix_partition import radix_partition
from ..utils.hashing import BIAS, mod_inverse_u32, to_numpy_u32, unbias
from ..utils.host import u64sum
from .config import JoinPlan, plan_join
from .phj import (
    _run_device,
    _scrambled,
    downgrade_plan_opts,
    phj_join,
    replan_from_span,
)
from .spill import _read_u32
from .stream import _Staging


@dataclasses.dataclass
class PartitionMeta:
    index: int
    build_rows: int
    probe_rows: int
    join_tuples: int


@dataclasses.dataclass
class GraceResult:
    join_tuples: int
    partitions: list  # PartitionMeta per partition
    f_bits: int
    # which sides reused their phase-1 partition files from a prior
    # run's spill (checksum-verified) instead of re-streaming
    reused_sides: dict = dataclasses.field(default_factory=dict)
    # partitions whose phase-2 join was resumed from the journal
    # (counts only; 0 whenever a row consumer is attached)
    resumed_partitions: int = 0
    # phase-1 chunks partitioned on the host (a pass overflow that cap
    # doubling could not fix), over both sides
    host_skew_chunks: int = 0
    # host-clock seconds of each phase ("partition", "join")
    seconds: dict = dataclasses.field(default_factory=dict)


class SpillCorrupt(ValueError):
    """A partition file failed its sidecar checksum at load time."""


def _append_u32(path: str, arr: np.ndarray) -> None:
    with open(path, "ab") as f:
        np.ascontiguousarray(arr, dtype="<u4").tofile(f)


def _side_sidecar(d: str, side: str) -> str:
    return os.path.join(d, f"{side}_partition.json")


def _side_fingerprint(keys, vals, factor: int, f_bits: int) -> dict:
    """What fixes the partition files' content as a multiset: the input
    rows (both columns) and the routing.  The chunk size only permutes
    rows within a file, which neither the join nor the checksums see."""
    return {"rows": int(len(keys)),
            "input_checksum": u64sum(np.asarray(keys, dtype=np.uint32)),
            "val_checksum": u64sum(np.asarray(vals, dtype=np.uint32)),
            "factor": int(factor), "f_bits": int(f_bits)}


def _try_resume_side(d: str, side: str, fp: dict):
    """(counts, hk checksums, val checksums) if `side`'s phase-1 spill
    matches this fingerprint and every partition file has its recorded
    length; else None.  Column checksums are verified at phase-2 load."""
    try:
        with open(_side_sidecar(d, side)) as f:
            meta = json.load(f)
        if {k: meta.get(k) for k in fp} != fp:
            return None
        counts = np.asarray(meta["counts"], np.int64)
        for p in range(1 << fp["f_bits"]):
            want = int(counts[p]) * 4
            for col in ("hk", "val"):
                path = os.path.join(d, f"{side}_{p}_{col}.bin")
                if os.path.getsize(path) != want:
                    return None
        return (counts, [int(c) for c in meta["hk_checksums"]],
                [int(c) for c in meta["val_checksums"]])
    except (OSError, ValueError, KeyError):
        return None


def _journal_path(d: str) -> str:
    return os.path.join(d, "join_progress.jsonl")


def _load_journal(d: str, fp: dict):
    """{partition: join_tuples} of the phase-2 journal when its header
    (both sides' fingerprints) matches this run, else None.  A torn last
    line from a crash is ignored: that partition joins again."""
    try:
        with open(_journal_path(d)) as f:
            lines = f.read().splitlines()
        if not lines or json.loads(lines[0]) != fp:
            return None
        done = {}
        for ln in lines[1:]:
            try:
                rec = json.loads(ln)
                done[int(rec["p"])] = int(rec["join_tuples"])
            except (ValueError, KeyError):
                continue
        return done
    except (OSError, ValueError):
        return None


def _start_journal(d: str, fp: dict) -> None:
    with open(_journal_path(d), "w") as f:
        f.write(json.dumps(fp) + "\n")


def _journal_append(d: str, p: int, jt: int) -> None:
    with open(_journal_path(d), "a") as f:
        f.write(json.dumps({"p": int(p), "join_tuples": int(jt)}) + "\n")


def _phase2_journal(d: str, side_fps: dict, on_partition):
    """Open or resume the phase-2 journal.  Returns the completed
    {partition: join_tuples}, forced empty with a row consumer (resuming
    would skip its callbacks; the journal is still written)."""
    fp = dict(side_fps)
    done = _load_journal(d, fp)
    if done is None:
        _start_journal(d, fp)
        done = {}
    return {} if on_partition else done


def _init_partition_files(d: str, side: str, F: int) -> None:
    """Truncate every partition file and drop a half-written sidecar
    from a crashed run (it must not resume)."""
    try:
        os.remove(_side_sidecar(d, side))
    except OSError:
        pass
    for p in range(F):
        for col in ("hk", "val"):
            open(os.path.join(d, f"{side}_{p}_{col}.bin"), "wb").close()


def _write_side_sidecar(d, side, fp, counts, hk_csums, val_csums) -> None:
    with open(_side_sidecar(d, side), "w") as f:
        json.dump({**fp, "counts": counts.tolist(),
                   "hk_checksums": hk_csums,
                   "val_checksums": val_csums}, f)


def _phase1(sides, spill_dir, factor, f_bits, partition_side):
    """Resume or compute both sides' phase-1 spills.
    partition_side(keys, vals, side, fp) runs one side's pass.  Returns
    (side_state, reused, side_fps, compute_side); compute_side serves
    the corrupt-spill recovery too."""
    side_state, reused, side_fps = {}, {}, {}

    def compute_side(side):
        k, v = sides[side]
        side_state[side] = partition_side(k, v, side, side_fps[side])
        reused[side] = False

    for side, (k, v) in sides.items():
        fp = side_fps[side] = _side_fingerprint(k, v, factor, f_bits)
        hit = _try_resume_side(spill_dir, side, fp)
        if hit is not None:
            side_state[side] = hit
            reused[side] = True
        else:
            compute_side(side)
    return side_state, reused, side_fps, compute_side


def _budget_caps_local(b_counts, p_counts, budget: int, f_bits: int,
                       plan: JoinPlan, device=None):
    """Enforce the per-partition budget, then derive the one (build,
    probe) capacity every pair pads to and the local plan: keys arrive
    scrambled, so factor 1, and the local engine skips the f_bits the
    routing consumed."""
    if int(b_counts.max(initial=0)) > budget or int(
        p_counts.max(initial=0)
    ) > budget:
        raise RuntimeError(
            f"a partition exceeds the per-partition budget "
            f"({int(max(b_counts.max(), p_counts.max()))} rows > "
            f"{budget}): re-run with f_bits={f_bits + 2} "
            "(one more level of the same pass handles any skew)"
        )
    nb_cap = -(-max(int(b_counts.max(initial=0)), 128) // 128) * 128
    np_cap = -(-max(int(p_counts.max(initial=0)), 128) // 128) * 128
    local = dataclasses.replace(
        plan_join(nb_cap, np_cap, device=device), factor=1,
        skip_bits=plan.skip_bits + f_bits,
    )
    return nb_cap, np_cap, local


def _make_loader(spill_dir, side_state, reused, compute_side):
    """load_side(side, p, n_rows) -> checksum-verified host (hk, val)
    uint32 columns.  A reused file that fails its checksum recomputes
    that side's pass once: same inputs and routing, so the counts (and
    every capacity) come out the same."""

    def load_column(side, p, n, col):
        path = os.path.join(spill_dir, f"{side}_{p}_{col}.bin")
        a = _read_u32(path, n)
        csums = side_state[side][1 if col == "hk" else 2]
        if u64sum(a) != csums[p]:
            raise SpillCorrupt(f"{path}: checksum mismatch")
        return a

    def load_side(side, p, n):
        if n == 0:
            z = np.zeros(0, np.uint32)
            return z, z
        for attempt in (0, 1):
            try:
                return (load_column(side, p, n, "hk"),
                        load_column(side, p, n, "val"))
            except SpillCorrupt:
                if attempt or not reused[side]:
                    raise
                old_counts = side_state[side][0]
                compute_side(side)
                if not np.array_equal(side_state[side][0], old_counts):
                    raise RuntimeError(
                        f"{side}: recomputed partition counts differ from "
                        "the spill's") from None

    return load_side


def _host_partition_fragments(hk: np.ndarray, vals: np.ndarray,
                              f_bits: int):
    """Exact host radix split of one chunk's scrambled uint32 keys (0 is
    null) -- the skew path.  The pass bounds each (tile, partition) run,
    so a chunk dominated by one hot key overflows at any capacity; the
    host split has no run bound, and the files' content (a multiset) is
    the same either way.  Null keys, tail pads included, are dropped as
    the pass drops them.  Returns ([(frag_hk, frag_val)] per partition,
    counts)."""
    live = hk != 0
    hk, vals = hk[live], vals[live]
    pid = (hk >> np.uint32(32 - f_bits)).astype(np.int64)
    order = np.argsort(pid, kind="stable")
    hk, vals, pid = hk[order], vals[order], pid[order]
    F = 1 << f_bits
    counts = np.bincount(pid, minlength=F).astype(np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    return [(hk[starts[p] : ends[p]], vals[starts[p] : ends[p]])
            for p in range(F)], counts


def _append_fragments(d: str, side: str, frags, counts, hk_csums,
                      val_csums) -> None:
    """Append per-partition fragments to the side's partition files,
    accumulating the counts and both column checksums."""
    for p, (frag_k, frag_v) in enumerate(frags):
        if not len(frag_k):
            continue
        _append_u32(os.path.join(d, f"{side}_{p}_hk.bin"), frag_k)
        _append_u32(os.path.join(d, f"{side}_{p}_val.bin"), frag_v)
        counts[p] += len(frag_k)
        hk_csums[p] = (hk_csums[p] + u64sum(frag_k)) % (1 << 64)
        val_csums[p] = (val_csums[p] + u64sum(frag_v)) % (1 << 64)


def _device_fragments(bk, bv, cnts, F: int):
    """Compact a pass's null-padded regions on the card and bring only
    the live rows to the host: [(scrambled uint32 keys, values)] per
    partition.  The counts are exact, so they split the compacted rows."""
    live = bk != BIAS
    keys = to_numpy_u32(unbias(bk[live]))
    vals = to_numpy_u32(bv[live])
    counts = cnts.cpu().numpy().astype(np.int64)
    if int(counts.sum()) != len(keys):
        raise RuntimeError(f"radix pass counts {int(counts.sum())} live "
                           f"rows, its regions hold {len(keys)}")
    ends = np.cumsum(counts)
    return [(keys[e - c : e], vals[e - c : e])
            for e, c in zip(ends.tolist(), counts.tolist())]


def _partition_side(
    keys, vals, factor: int, f_bits: int, chunk_rows: int, d: str,
    side: str, fp: dict | None = None, device=None, cap_retries: int = 3,
):
    """Stream one relation through the card's radix pass and append the
    compacted fragments to the per-partition files
    ``{side}_{p}_{hk,val}.bin``.  Returns (per-partition row counts, hk
    checksums, val checksums, chunks partitioned on the host).  Every
    chunk, the tail too, is zero-padded to one chunk length (null keys
    are dropped by the pass), so the pass's geometry, and its overflow,
    is the JAX package's."""
    dev = _run_device(device)
    F = 1 << f_bits
    n = len(keys)
    counts = np.zeros(F, np.int64)
    hk_csums = [0] * F
    val_csums = [0] * F
    host_chunks = 0
    if fp is None:
        fp = _side_fingerprint(keys, vals, factor, f_bits)
    _init_partition_files(d, side, F)
    eff = min(chunk_rows, n)
    starts = list(range(0, n, eff)) if eff else []
    with _Staging(dev, [eff, eff]) as staging:

        def upload(i):
            s = starts[i]
            return staging.upload([keys[s : s + eff], vals[s : s + eff]],
                                  [eff, eff])

        handle = upload(0) if starts else None
        for i in range(len(starts)):
            ck, cv = staging.take(handle)
            hk, v = _scrambled(ck, cv, factor)
            staging.release(handle)
            # the pass's own capacity estimate first
            bk, bv, cnts, ovf = radix_partition(hk, v, f_bits)
            # the next chunk's host read and copy overlap this pass
            handle = upload(i + 1) if i + 1 < len(starts) else None
            for _ in range(cap_retries):
                if int(ovf) == 0:
                    break
                # overflow is a value: retry with a doubled capacity
                bk, bv, cnts, ovf = radix_partition(
                    hk, v, f_bits, cap=2 * (bk.shape[0] // F))
            if int(ovf) == 0:
                frags = _device_fragments(bk, bv, cnts, F)
            else:
                # a persistent overflow is the pass's per-tile run bound
                # (one hot key dominating the chunk), which capacity can
                # never fix: partition this chunk exactly on the host
                frags, _ = _host_partition_fragments(
                    to_numpy_u32(unbias(hk)), to_numpy_u32(v), f_bits)
                host_chunks += 1
            del bk, bv, hk, v
            _append_fragments(d, side, frags, counts, hk_csums, val_csums)
    _write_side_sidecar(d, side, fp, counts, hk_csums, val_csums)
    return counts, hk_csums, val_csums, host_chunks


def grace_join(
    inner_keys,
    inner_vals,
    outer_keys,
    outer_vals,
    f_bits: int = 6,
    chunk_rows: int = 32_000_000,
    spill_dir: str | None = None,
    plan: JoinPlan | None = None,
    partition_budget_rows: int = 220_000_000,
    on_partition=None,
    window_retries: int = 3,
    device=None,
) -> GraceResult:
    """Join two host-resident relations, neither of which needs to fit
    the card.  All four inputs are numpy uint32 arrays or np.memmap;
    ``device`` is the card by default, "cpu" runs the plain versions.

    on_partition(meta, res, raw_probe_keys) is called per partition with
    its JoinResult (flat columns on the device, probe keys still
    scrambled) and the probe keys unscrambled as host uint32 -- the hook
    for consumers of rows; without it only counts are summed.  spill_dir
    holds the partition files and is required."""
    if spill_dir is None:
        raise ValueError("grace_join needs spill_dir for partition files")
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    dev = _run_device(device)
    os.makedirs(spill_dir, exist_ok=True)
    if plan is None:
        # per-pair planning happens below; this fixes the scramble
        # factor the pass routes on
        plan = plan_join(
            max(1, len(inner_keys) >> f_bits),
            max(1, len(outer_keys) >> f_bits), device=dev,
        )
    F = 1 << f_bits
    sides = {"build": (inner_keys, inner_vals),
             "probe": (outer_keys, outer_vals)}
    skew = {}
    t0 = time.perf_counter()

    def partition_side(k, v, side, fp):
        *state, skew[side] = _partition_side(
            k, v, plan.factor, f_bits, chunk_rows, spill_dir, side, fp, dev)
        return tuple(state)

    side_state, reused, side_fps, compute_side = _phase1(
        sides, spill_dir, plan.factor, f_bits, partition_side)
    t1 = time.perf_counter()
    b_counts = side_state["build"][0]
    p_counts = side_state["probe"][0]
    nb_cap, np_cap, local = _budget_caps_local(
        b_counts, p_counts, partition_budget_rows, f_bits, plan, dev)
    inv = mod_inverse_u32(plan.factor)
    total = 0
    load_side = _make_loader(spill_dir, side_state, reused, compute_side)
    live = [p for p in range(F) if int(b_counts[p]) and int(p_counts[p])]
    metas = [PartitionMeta(p, int(b_counts[p]), int(p_counts[p]), 0)
             for p in range(F)]
    # partitions already joined by a prior run over the same inputs and
    # routing (the journal) add their recorded counts and are skipped
    done = _phase2_journal(spill_dir, side_fps, on_partition)
    resumed = 0
    for p in [q for q in live if q in done]:
        metas[p].join_tuples = done[p]
        total += done[p]
        resumed += 1
    live = [p for p in live if p not in done]
    with _Staging(dev, [nb_cap, nb_cap, np_cap, np_cap]) as staging:

        def load_pair(p):
            # read and verify first, then issue the copies
            bk, bv = load_side("build", p, int(b_counts[p]))
            pk, pv = load_side("probe", p, int(p_counts[p]))
            return staging.upload([bk, bv, pk, pv],
                                  [nb_cap, nb_cap, np_cap, np_cap])

        handle = load_pair(live[0]) if live else None
        for idx, p in enumerate(live):
            meta = metas[p]
            cols = staging.take(handle)
            res = phj_join(*cols, local)
            # double buffering: the next pair's disk read and copy are
            # issued only after this join is dispatched, so they overlap
            # it instead of delaying it
            nxt = load_pair(live[idx + 1]) if idx + 1 < len(live) else None
            win_ovf, span, sel_ovf = res.build_counts.tolist()
            for _ in range(window_retries):
                if win_ovf == 0 and sel_ovf == 0:
                    break
                res = None
                if sel_ovf:
                    # a counted plan-opt violation: drop the flags
                    local = downgrade_plan_opts(local)
                if win_ovf:
                    local = replan_from_span(local, span)
                res = phj_join(*cols, local)
                win_ovf, span, sel_ovf = res.build_counts.tolist()
            if win_ovf or sel_ovf:
                raise RuntimeError(f"partition {p}: window overflow persists")
            staging.release(handle)
            handle = nxt
            # the int64 sum: a partition past 2^32 output rows does not
            # wrap (the JAX package corrects its u32 sum through float32)
            jt = int(res.join_tuples)
            meta.join_tuples = jt
            total += jt
            _journal_append(spill_dir, p, jt)
            if on_partition:
                raw_pk = (to_numpy_u32(res.probe_keys).astype(np.uint64)
                          * inv % (1 << 32)).astype(np.uint32)
                on_partition(meta, res, raw_pk)
    t2 = time.perf_counter()
    return GraceResult(total, metas, f_bits, reused_sides=dict(reused),
                       resumed_partitions=resumed,
                       host_skew_chunks=sum(skew.values()),
                       seconds={"partition": t1 - t0, "join": t2 - t1})
