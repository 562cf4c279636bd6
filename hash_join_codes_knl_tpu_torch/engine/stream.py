"""Out-of-core streaming join: probe relations larger than device memory.

Counterpart of ``hash_join_codes_knl_tpu/engine/stream.py``.  The build
side is sorted once and stays on the card; the probe side lives in host
RAM (a numpy array or an np.memmap: it never has to fit the card) and
streams through in chunks of ``chunk_rows``.  Each chunk runs the merge
pipeline's probe stages (engine/phj.py ``_staged_fns``: K1 and the chunk
sort, the windows, the window probe) against the resident build order.

Double buffering (``_Staging``): two pinned host buffers and two device
buffers per column, and a side copy stream.  Chunk k+1 is read into a
pinned buffer and its copy issued on the copy stream while the card
still works on chunk k;
an event tells the compute stream when the copy is done, another tells
the copy stream when the compute stream has read a device buffer, and
the host waits for a pinned buffer's last copy before refilling it.
Only the two in-flight chunks are ever pinned, never the relation.

Checkpoint and resume (engine/spill.py files): each completed chunk
spills its match columns (match_vals, match_cnts, flat, in the chunk's
sorted order; the probe columns are a deterministic replay of the input
chunk and are not duplicated on disk) and a sidecar with the chunk's
input checksum, its join count, the plan fingerprint (factor, chunk
count, cap: what fixes the row order) and the build side's fingerprint.
A rerun verifies sidecar and columns and skips completed chunks; on_chunk
then gets a ``SpilledChunk`` of the verified columns, and
``replay_probe_columns`` rebuilds the aligned probe columns with the
live path's own sort, so a port spill realigns slot for slot.  The
files are the JAX package's format: a spill written by either package
resumes in the other (the JAX probe sort is unstable, so there the rows
realign as a multiset: within a chunk, rows of equal key have equal
match columns).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os

import numpy as np
import torch

from ..ops.scramble import unscramble
from ..utils.hashing import to_numpy_u32, u32_to_device
from ..utils.host import u64sum
from .config import JoinPlan, plan_join
from .phj import (
    _as_column,
    _merge_params,
    _merge_sort_probe,
    _run_device,
    _staged_fns,
    downgrade_plan_opts,
    replan_window_cap,
    window_from_span,
)
from .spill import _read_u32, _write_u32

_FILL_THREADS = 8
_FILL_MIN = 1 << 22  # rows a copy thread takes at least


@dataclasses.dataclass
class ChunkMeta:
    index: int
    rows: int
    join_tuples: int
    resumed: bool
    window_overflow: int


@dataclasses.dataclass
class SpilledChunk:
    """Checksum-verified match columns of a chunk resumed from its spill,
    handed to on_chunk in place of the live JoinResult.  The aligned
    probe columns are a deterministic replay of the input chunk:
    ``replay_probe_columns(chunk_keys, chunk_vals, plan, cap)``, on the
    card unless ``device="cpu"`` is passed."""

    match_vals: np.ndarray  # (cap,) uint32, the chunk's sorted order
    match_cnts: np.ndarray  # (cap,) int32


@dataclasses.dataclass
class StreamResult:
    join_tuples: int
    chunks: list  # ChunkMeta per chunk
    plan: JoinPlan
    # on the card: bytes copied host to device, the copies' summed
    # device ms (copy-stream events around each copy) and the part of it
    # that overlapped the chunks' compute (compute-stream events)
    transfer: dict = dataclasses.field(default_factory=dict)

    @property
    def resumed_chunks(self) -> int:
        return sum(c.resumed for c in self.chunks)


def _fill(pool, dst: np.ndarray, src) -> None:
    """Copy host column `src` into dst[:len(src)], in parallel slices
    (numpy releases the interpreter lock while it copies)."""
    n = len(src)
    parts = max(1, min(_FILL_THREADS, n // _FILL_MIN))
    bounds = [n * i // parts for i in range(parts + 1)]
    list(pool.map(
        lambda i: np.copyto(dst[bounds[i]:bounds[i + 1]],
                            src[bounds[i]:bounds[i + 1]], casting="no"),
        range(parts)))


class _Staging:
    """Double-buffered host-to-device staging of column groups.

    ``upload(cols, pad_to)`` copies host uint32 columns into the next of
    two slots, each column zero-padded on the device to pad_to[i] rows;
    ``take(handle)`` makes the current stream wait for that copy and
    returns the device columns; ``release(handle)`` marks the slot's
    device columns read by everything queued so far, so the slot may be
    refilled.  On the CPU the three are plain copies.  Use as a context
    manager: closing waits for the copy stream and stops the copy
    threads."""

    def __init__(self, device, rows):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.next = 0
        self.copies = []  # (start event, end event, bytes) per copy
        if not self.cuda:
            return
        self.pool = concurrent.futures.ThreadPoolExecutor(_FILL_THREADS)
        self.host = [[torch.empty(r, dtype=torch.int32, pin_memory=True)
                      for r in rows] for _ in range(2)]
        self.dev = [[torch.empty(r, dtype=torch.int32, device=self.device)
                     for r in rows] for _ in range(2)]
        self.stream = torch.cuda.Stream(self.device)
        # the allocator must not hand these buffers out again while the
        # copy stream may still write them
        for d in (d for slot in self.dev for d in slot):
            d.record_stream(self.stream)
        self.base = torch.cuda.Event(enable_timing=True)
        self.base.record(torch.cuda.current_stream(self.device))
        self.stream.wait_event(self.base)
        self.copied = [None, None]  # the slot's last copy is done
        self.consumed = [None, None]  # the slot's device columns are read

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.stream.synchronize()
            self.pool.shutdown()

    def upload(self, cols, pad_to):
        cols = [np.asarray(c, dtype=np.uint32) for c in cols]
        if not self.cuda:
            out = []
            for c, n in zip(cols, pad_to):
                t = torch.zeros(n, dtype=torch.int32)
                t[:len(c)] = u32_to_device(c, "cpu")
                out.append(t)
            return None, out
        b = self.next
        self.next ^= 1
        if self.copied[b] is not None:
            self.copied[b].synchronize()  # pinned slot b is free again
        if self.consumed[b] is not None:
            self.stream.wait_event(self.consumed[b])
        # every column filled first, then the copies: filling in pieces
        # while earlier pieces copied made the stream slower on the
        # H100's host (PERF.md), fill and copy contending for host
        # memory
        for h, c in zip(self.host[b], cols):
            _fill(self.pool, h.numpy().view(np.uint32), c)
        out = []
        with torch.cuda.stream(self.stream):
            for h, d, c, n in zip(self.host[b], self.dev[b], cols, pad_to):
                m = len(c)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record(self.stream)
                d[:m].copy_(h[:m], non_blocking=True)
                ev[1].record(self.stream)
                d[m:n].zero_()
                self.copies.append((*ev, 4 * m))
                out.append(d[:n])
        done = torch.cuda.Event()
        done.record(self.stream)
        self.copied[b] = done
        return b, out

    def take(self, handle):
        b, out = handle
        if b is not None:
            torch.cuda.current_stream(self.device).wait_event(self.copied[b])
        return out

    def release(self, handle) -> None:
        b, _ = handle
        if b is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.consumed[b] = ev

    def transfer(self, computes) -> dict:
        """Bytes copied, the copies' device ms, and the ms of copy that
        overlapped the (start, end) event pairs `computes` (recorded on
        the compute stream).  Synchronizes."""
        if not self.cuda:
            return {}
        torch.cuda.synchronize(self.device)
        at = self.base.elapsed_time
        spans = [(at(a), at(b)) for a, b in computes]
        total = hidden = 0.0
        for a, b, _ in self.copies:
            s, e = at(a), at(b)
            total += e - s
            hidden += sum(max(0.0, min(e, ce) - max(s, cs))
                          for cs, ce in spans)
        return {"h2d_bytes": sum(c[2] for c in self.copies),
                "h2d_ms": total, "hidden_ms": hidden,
                "compute_ms": sum(ce - cs for cs, ce in spans)}


def _timing_event(device):
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _host_u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return to_numpy_u32(x)
    return np.asarray(x, dtype=np.uint32)


def _sidecar_path(d: str, k: int) -> str:
    return os.path.join(d, f"chunk_{k:06d}.json")


def _spill_chunk(d: str, k: int, mval: np.ndarray, mcnt: np.ndarray,
                 meta: dict) -> None:
    mcnt = mcnt.astype(np.uint32)
    _write_u32(os.path.join(d, f"chunk_{k:06d}_mval.bin"), mval)
    _write_u32(os.path.join(d, f"chunk_{k:06d}_mcnt.bin"), mcnt)
    meta = dict(meta, mval_checksum=u64sum(mval), mcnt_checksum=u64sum(mcnt))
    with open(_sidecar_path(d, k), "w") as f:
        json.dump(meta, f)


def _plan_fingerprint(plan: JoinPlan, cap: int) -> dict:
    """The plan fields that fix the spilled columns' row order: the
    scramble factor, the probe chunk count and the padded capacity
    (tile and window shape the probe, not the output order)."""
    return {"factor": plan.factor,
            "probe_chunks": max(1, plan.probe_chunks), "cap": cap}


def _build_fingerprint(inner_keys, inner_vals) -> dict:
    """Identity of the build side a chunk's results were computed
    against: a resume against a changed build relation recomputes."""
    return {
        "build_rows": int(len(inner_keys)),
        "build_keys_checksum": u64sum(_host_u32(inner_keys)),
        "build_vals_checksum": u64sum(_host_u32(inner_vals)),
    }


def _try_resume_chunk(d: str, k: int, input_checksum: int, rows: int,
                      cap: int, plan: JoinPlan, build_fp: dict):
    """(sidecar meta, SpilledChunk) if chunk k's spill is present,
    matches this input, this build side and this plan's row-order
    fingerprint, and passes both column checksums; else None (the chunk
    recomputes)."""
    try:
        with open(_sidecar_path(d, k)) as f:
            meta = json.load(f)
        if meta["input_checksum"] != input_checksum or meta["rows"] != rows:
            return None
        fp = dict(_plan_fingerprint(plan, cap), **build_fp)
        if {key: meta.get(key) for key in fp} != fp:
            return None
        mval = _read_u32(os.path.join(d, f"chunk_{k:06d}_mval.bin"), cap)
        mcnt = _read_u32(os.path.join(d, f"chunk_{k:06d}_mcnt.bin"), cap)
        if (u64sum(mval) != meta["mval_checksum"]
                or u64sum(mcnt) != meta["mcnt_checksum"]):
            return None
        return meta, SpilledChunk(mval, mcnt.view(np.int32))
    except (OSError, ValueError, KeyError):
        return None


def replay_probe_columns(chunk_keys, chunk_vals, plan: JoinPlan, cap: int,
                         device=None):
    """The aligned probe columns (probe_keys, probe_vals), host uint32,
    of a chunk: its rows null-padded to cap and sorted as the live path
    sorts them (K1 and the stable chunk sort), keys unscrambled.  With a
    SpilledChunk's match columns this is the chunk's full result.
    ``device`` is the card by default (RuntimeError where there is none);
    "cpu" runs the plain versions."""
    device = _run_device(device)
    k = u32_to_device(np.asarray(chunk_keys, dtype=np.uint32), device)
    v = u32_to_device(np.asarray(chunk_vals, dtype=np.uint32), device)
    hk, pv = _merge_sort_probe(k, v, cap, plan.probe_chunks, plan.factor)
    return to_numpy_u32(unscramble(hk, plan.factor)), to_numpy_u32(pv)


def stream_join(
    inner_keys,
    inner_vals,
    outer_keys,
    outer_vals,
    chunk_rows: int,
    plan: JoinPlan | None = None,
    spill_dir: str | None = None,
    window_retries: int = 3,
    on_chunk=None,
    device=None,
) -> StreamResult:
    """Join a build side held on the card against a host-resident probe
    side.

    inner_*: numpy uint32 columns or int32 bit tensors; outer_*: host
    numpy arrays or np.memmap, of which only two chunks of `chunk_rows`
    are ever staged.  ``device`` is the card by default; "cpu" runs the
    plain versions.  spill_dir enables checkpoint and resume.  on_chunk,
    if given, is called with (ChunkMeta, payload) per chunk: the live
    JoinResult (flat columns on the device) for a computed chunk, a
    SpilledChunk (flat host columns) for a resumed one.  The prefetch
    skips resumed chunks: the chunk in flight is always the next that
    computes.  A window overflow re-plans the window only (the spill
    pins the tile and chunk geometry) and raises past the gather cap."""
    if chunk_rows <= 0:
        raise ValueError("chunk_rows must be positive")
    dev = _run_device(device)
    ni = len(inner_keys)
    no = len(outer_keys)
    if plan is None:
        plan = plan_join(ni, min(no, chunk_rows), device=dev)
    tile, window, rows_total, cap = _merge_params(plan, ni, chunk_rows)
    plan = dataclasses.replace(plan, window=window)
    build_fp = (_build_fingerprint(inner_keys, inner_vals)
                if spill_dir else {})
    if spill_dir:
        os.makedirs(spill_dir, exist_ok=True)
    ik, iv = _as_column(inner_keys, dev), _as_column(inner_vals, dev)
    sort_side, windows, probe = _staged_fns(plan, tile, window, rows_total)
    bhk, bval = sort_side(ik, iv, rows_total * 128, True)

    n_chunks = -(-no // chunk_rows)

    # one-entry host cache: in spill mode get_status reads a chunk to
    # checksum it, and its upload follows at once
    host_cache: dict = {}

    def host_chunk(k):
        if k in host_cache:
            return host_cache.pop(k)
        sl = slice(k * chunk_rows, min((k + 1) * chunk_rows, no))
        return outer_keys[sl], outer_vals[sl]

    # each chunk's resume status is settled on the host (sidecar reads)
    # before any prefetch, so the chunk in flight is always the next
    # that computes and a resumed chunk never forces a synchronous fetch
    status: dict = {}  # k -> (rows, checksum, resume or None)

    def get_status(k):
        if k not in status:
            if spill_dir:
                ck, cv = host_chunk(k)
                host_cache.clear()
                host_cache[k] = (ck, cv)
                csum = u64sum(np.asarray(ck, dtype=np.uint32))
                resume = _try_resume_chunk(spill_dir, k, csum, len(ck), cap,
                                           plan, build_fp)
                status[k] = (len(ck), csum, resume)
            else:
                status[k] = (min(chunk_rows, no - k * chunk_rows), None,
                             None)
        return status[k]

    def next_compute(k):
        """First chunk index >= k that computes (n_chunks if none)."""
        while k < n_chunks and get_status(k)[2] is not None:
            k += 1
        return k

    def upload(k):
        ck, cv = host_chunk(k)
        return staging.upload([ck, cv], [len(ck), len(cv)])

    chunks: list[ChunkMeta] = []
    computes = []  # (start, end) compute-stream events per chunk
    total = 0
    pending = None  # (chunk index, staging handle) in flight
    with _Staging(dev, [chunk_rows, chunk_rows]) as staging:
        for k in range(n_chunks):
            rows, csum, resume = get_status(k)
            if resume is not None:
                meta, spilled = resume
                cm = ChunkMeta(k, rows, meta["join_tuples"], True,
                               meta["window_overflow"])
                chunks.append(cm)
                total += cm.join_tuples
                if on_chunk:
                    on_chunk(cm, spilled)
                continue
            handle = (pending[1] if pending and pending[0] == k
                      else upload(k))
            dk, dv = staging.take(handle)
            t0 = _timing_event(dev)
            # sort_side scrambles (K1), raw keys in
            ohk, ov = sort_side(dk, dv, cap)
            res = probe(bhk, bval, ohk, ov, *windows(bhk, ohk))
            t1 = _timing_event(dev)
            # the next computing chunk's host read and copy overlap this
            # chunk's compute, which the host only waits for below
            nk = next_compute(k + 1)
            pending = (nk, upload(nk)) if nk < n_chunks else None
            ovf, span, sel_ovf = res.build_counts.tolist()
            for _ in range(window_retries):
                if ovf == 0 and sel_ovf == 0:
                    break
                if sel_ovf:
                    # a counted plan-opt violation: drop the flags; the
                    # geometry, and so the spill fingerprint, stays
                    plan = downgrade_plan_opts(plan)
                if ovf:
                    # a skewed chunk overflowed its window: re-plan this
                    # and every later chunk from the measured span,
                    # window only (the spill pins tile and chunk
                    # geometry), so past the gather cap it raises
                    window = max(window + 128, window_from_span(span))
                    if window > replan_window_cap(tile):
                        raise RuntimeError(
                            f"chunk {k}: measured span {span} needs a "
                            f"{window}-slot window, past the "
                            f"{replan_window_cap(tile)}-slot gather cap at "
                            f"tile {tile}; the spill pins this geometry -- "
                            "rerun with a smaller tile or chunk_rows "
                            "(fresh spill_dir) so the span shrinks with "
                            "the tile"
                        )
                    plan = dataclasses.replace(plan, window=window)
                tile, window, rows_total, cap2 = _merge_params(
                    plan, ni, chunk_rows)
                assert cap2 == cap
                sort_side, windows, probe = _staged_fns(plan, tile, window,
                                                        rows_total)
                bhk, bval = sort_side(ik, iv, rows_total * 128, True)
                ohk, ov = sort_side(dk, dv, cap)
                res = probe(bhk, bval, ohk, ov, *windows(bhk, ohk))
                t1 = _timing_event(dev)
                ovf, span, sel_ovf = res.build_counts.tolist()
            if ovf != 0 or sel_ovf != 0:
                raise RuntimeError(
                    f"chunk {k}: window overflow persists after re-planning"
                )
            staging.release(handle)
            if t0 is not None:
                computes.append((t0, t1))
            jt = int(res.join_tuples)
            cm = ChunkMeta(k, rows, jt, False, ovf)
            if spill_dir:
                _spill_chunk(
                    spill_dir, k, to_numpy_u32(res.match_vals),
                    res.match_cnts.cpu().numpy(),
                    {"index": k, "rows": rows, "input_checksum": csum,
                     "join_tuples": jt, "window_overflow": ovf,
                     "window": window, "tile": tile,
                     **_plan_fingerprint(plan, cap), **build_fp},
                )
            chunks.append(cm)
            total += jt
            if on_chunk:
                on_chunk(cm, res)
        transfer = staging.transfer(computes)
    return StreamResult(total, chunks, plan, transfer)
