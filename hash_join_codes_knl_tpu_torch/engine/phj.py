"""PHJ: the single-device partitioned hash join.

Counterpart of ``hash_join_codes_knl_tpu/engine/phj.py`` (``join`` ->
``phj_join``), which dispatches on the plan's ``probe_impl``:

- the merge modes ("merge*", ``phj_join_merge``, the default plan);
- the padded modes ("auto", "pallas", "jnp", ``_phj_join_padded``):
  both relations partitioned by the top hash bits, the build side packed
  into a dense (P, slots) table, the probe side laid out partition by
  partition in tile-aligned regions, and every probe tile swept against
  its partition's row (ops/probe.py).  ``partition_impl`` "sort" and
  "argsort" lay out by one stable sort (ops/partition.py); "radix" runs
  the multi-pass radix partitioner on both sides
  (ops/radix_partition.py).

Merge mode: both relations are ordered by the scrambled key, the build
side by one sort, the probe side as ``probe_chunks`` independently
sorted chunks.  Each probe tile's matches then lie in one contiguous
build window, located by a coarse searchsorted, and a window probe
kernel finds every probe's match count and maximum matched value: K2
(ops/merge_probe.py) builds a shared-memory hash table of each window,
in rounds, at any width; K3 and K4 (ops/merge_probe_gather.py) search
the sorted window staged in shared memory.  A window too narrow for
some tile is counted, never silent, and ``join`` re-plans from the
measured span.  The padded modes are not re-planned: their overflow
raises.

Key domain (utils/hashing.py): on the device every key is a biased
scrambled key, ``bias(key * factor mod 2^32)`` in an int32 tensor, and
every value the uint32 bits in an int32 tensor.  Columns are flat
(cap,): the JAX package's chunk-row 2-D form exists only for TPU
retiling.

Two-class window geometry (``plan.window_wide > 0``): a narrow first
pass at ``plan.window`` over every tile, then K4
(``merge_probe_gather_indexed``) re-probes the first ``wide_cap`` tiles
whose span exceeds it at ``window_wide``, in place.  More wide tiles
than ``wide_cap`` is a counted plan-opt violation; join() then collapses
the plan to one class at ``window_wide``.

``phj_join_merge_staged`` runs the merge stages as timed phases (the
CLI's ``--timelog``), and ``materialize_expanded`` expands M:N results
into rows (ops/expand.py).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..ops.chunk_layout import flat_to_rows
from ..ops.merge_probe import merge_probe, merge_probe_torch
from ..ops.merge_probe_gather import (
    merge_probe_gather,
    merge_probe_gather_indexed,
)
from ..ops.partition import (
    build_dense_table,
    partition_padded,
    pids_from_hk,
    tile_pids,
)
from ..ops.probe import probe_tiles, probe_tiles_torch
from ..ops.radix_partition import multipass_partition
from ..utils.hashing import (
    BIAS,
    mod_inverse_u32,
    mul_u32,
    to_numpy_u32,
    u32_to_device,
    unbias,
)
from .config import JoinPlan, plan_join

# biased forms of the unsigned keys 1 and 0xFFFFFFFF
_BIASED_ONE = BIAS + 1
_BIASED_MAX = 2**31 - 1
_U32_MASK = 0xFFFFFFFF

# The window caps below are the JAX package's TPU compile limits
# (engine/phj.py there: Mosaic scoped-VMEM budgets and the gather
# kernel's lane cap).  They mean nothing to the H100 kernels; they are
# kept only so that plans, windows and overflow statistics agree one to
# one with the reference.  Re-deriving them from Hopper measurements is
# open work (PERF.md).
GATHER_MIN_CHUNKS = 10
GATHER_ROWCHUNK_BUDGET = 24 * 121
GATHER_MAX_CHUNKS = 121
DENSE_ROWCHUNK_BUDGET = 2048


@dataclasses.dataclass
class JoinResult:
    """Aligned join output over the padded probe layout: slot i carries
    (probe key, probe val, matched build val, match count).  Four flat
    (cap,) int32 columns holding uint32 bits, probe keys unscrambled,
    in the probe sort's order."""

    probe_keys: torch.Tensor
    probe_vals: torch.Tensor
    match_vals: torch.Tensor  # max build value over the matches, or 0
    match_cnts: torch.Tensor  # number of build matches
    # merge modes: [window-overflow tile count, max required span,
    # plan-opt violations]; padded sort modes: the P build partition
    # counts (overflow where one exceeds plan.slots); radix mode: the P
    # build partition counts, then the summed pass overflow (P+1 entries)
    build_counts: torch.Tensor

    @property
    def join_tuples(self) -> torch.Tensor:
        """Join cardinality as a 0-d int64 tensor (the JAX package sums
        in uint32 and wraps at 2^32)."""
        return self.match_cnts.sum(dtype=torch.int64)


def _merge_params(plan: JoinPlan, ni: int, no: int):
    """Static geometry of the merge pipeline: (tile, window, rows_total,
    cap), exactly as the JAX package derives it.  The auto window covers
    a tile's expected build span (mean plus fluctuation terms plus the
    row-granular anchor margin); with probe_chunks the span grows by
    about the chunk count, and cap becomes a multiple of chunks * tile
    so no tile straddles two chunks.  A two-class plan needs an explicit
    narrow window below window_wide, and its wide pass is the gather
    kernel (K4), so window_wide is checked against the gather ceiling."""
    tile = plan.tile
    chunks = max(1, plan.probe_chunks)
    quantum = tile * chunks
    cap = -(-no // quantum) * quantum
    if chunks % 8 == 0 and (cap // chunks) % 1024:
        # the TPU relayout kernel's 1024-slot row rule, kept for parity
        quantum *= 8
        cap = -(-no // quantum) * quantum
    if plan.window_wide:
        if not plan.window or plan.window_wide <= plan.window:
            raise ValueError(
                "window_wide requires an explicit narrow window smaller "
                f"than it (got window={plan.window}, "
                f"window_wide={plan.window_wide})"
            )
        _check_explicit_window(
            dataclasses.replace(plan, probe_impl="merge_gather"),
            tile, plan.window_wide,
        )
    if plan.window:
        window = plan.window
        _check_explicit_window(plan, tile, window)
    else:
        lam = tile * ni / max(cap // chunks, 1)
        window = int(
            max(384, lam + 8 * (lam ** 0.5) + 8 * lam / (tile ** 0.5) + 520)
        )
        window = min(window, replan_window_cap(tile))
    window = -(-window // 128) * 128
    rows_total = max(-(-ni // 128), window // 128)
    return tile, window, rows_total, cap


def _packed_sort(hk: torch.Tensor, vals: torch.Tensor):
    """Sort (biased key, value) pairs by key, then value: one sort of
    the packed int64 (key << 32) | uint32(value), which gives the order
    lax.sort(num_keys=2) gives.  Returns flat columns."""
    packed = (hk.to(torch.int64) << 32) | (vals.to(torch.int64) & _U32_MASK)
    s = torch.sort(packed, dim=-1).values.view(-1)
    return (s >> 32).to(torch.int32), s.to(torch.int32)


def _key_sort_rows(hk: torch.Tensor, vals: torch.Tensor):
    """Sort each row by key alone and gather the values after it.  The
    probe needs no value order, and this took 20.8 ms against the packed
    sort's 49.7 ms at 256M rows on an H100 (PERF.md).  Stable, so CPU and
    CUDA runs agree slot for slot.  Returns flat columns."""
    ohk, order = torch.sort(hk, dim=-1, stable=True)
    return ohk.view(-1), torch.gather(vals, -1, order).view(-1)


def _merge_sort_side(keys, vals, pad_to: int, factor: int):
    """Build side: scramble, bias and null-pad to pad_to (K1, which also
    does the JAX package's _pad_pair), then sort by (key, value).  Pads
    sort to the front.  The value-secondary order is what the gather
    probe's max value relies on; it is kept under unique_build too, where
    it costs nothing extra in one packed sort."""
    return _packed_sort(*flat_to_rows(keys, vals, pad_to, 1, factor))


def _merge_sort_probe(keys, vals, pad_to: int, chunks: int, factor: int):
    """Probe side: K1 into the (chunks, pad_to/chunks) view, then each
    chunk sorted independently by key (chunks <= 1 is one global sort).
    Returns flat (pad_to,) columns: the row-major flattening is the
    padded layout.  The JAX probe sort is unstable, so probe values agree
    with it only as a multiset; keys agree slot for slot."""
    return _key_sort_rows(*flat_to_rows(keys, vals, pad_to, max(1, chunks),
                                        factor))


def _window_rows(bhk, ohk, tile: int, rows_total: int):
    """Unclamped anchor row and end row of every probe tile, from a
    coarse searchsorted of the tile's first and last key against the
    first key of every 128-slot build row.

    Anchors are row-granular: the left search minus one row (with
    duplicate keys a run can start inside the row before the first row
    whose first key reaches the tile minimum), never before the last row
    that holds a build pad.  Rows from the end row on hold only keys past
    the tile's maximum."""
    lo = ohk[::tile].contiguous()
    hi = ohk[tile - 1 :: tile].contiguous()
    coarse = bhk.view(rows_total, 128)[:, 0].contiguous()
    wrow = torch.searchsorted(coarse, lo) - 1
    hi_row = torch.where(hi == _BIASED_MAX, rows_total,
                         torch.searchsorted(coarse, hi, right=True))
    first_real = torch.searchsorted(
        coarse, torch.full((1,), _BIASED_ONE, dtype=torch.int32,
                           device=coarse.device)) - 1
    return torch.maximum(wrow, first_real), hi_row


def _anchored(wrow_raw, hi_row, window: int, rows_total: int):
    """Anchor rows clipped so a `window`-slot window fits the build side,
    and each tile's required span in slots from its anchor."""
    wrow = wrow_raw.clamp(0, rows_total - window // 128)
    return wrow, (hi_row - wrow) * 128


def _merge_windows(bhk, ohk, tile: int, window: int, rows_total: int,
                   window_wide: int = 0, wide_cap: int = 0):
    """Per-tile window anchor rows (_window_rows), clipped so the window
    fits the build side.  Returns (wrow, stats), stats = [count of tiles
    whose span exceeds the window, max required span].

    window_wide > 0 (the two-class geometry) adds a third value (tidx,
    wrow_wide, wide_ovf): the first wide_cap tiles whose span exceeds the
    narrow window, in ascending order, then narrow tiles in ascending
    order as pads (re-probing a tile at a wider window from a lower
    anchor is idempotent: the extra slots hold keys outside the tile's
    range); their anchors re-clamped for the wide width; and the count of
    wide tiles past wide_cap (a plan-opt violation).  stats[0] then
    counts only spans past the wide window, and the max span takes the
    wide span for wide tiles."""
    wrow_raw, hi_row = _window_rows(bhk, ohk, tile, rows_total)
    wrow, span = _anchored(wrow_raw, hi_row, window, rows_total)
    if not window_wide:
        overflow = (span > window).sum()
        max_span = span.max() if span.numel() else overflow.new_zeros(())
        return wrow.to(torch.int32), torch.stack([overflow, max_span])
    wrow_w, span_w = _anchored(wrow_raw, hi_row, window_wide, rows_total)
    wide = span > window
    overflow = (wide & (span_w > window_wide)).sum()
    spans = torch.where(wide, span_w, span)
    max_span = spans.max() if spans.numel() else overflow.new_zeros(())
    wide_ovf = (wide.sum() - wide_cap).clamp(min=0)
    # wide tiles first, each class in ascending tile order: a stable sort
    # of the class flag equals the JAX package's (flag, index) sort
    order = torch.sort((~wide).to(torch.int32), stable=True).indices
    tidx = order[:wide_cap]
    return (wrow.to(torch.int32), torch.stack([overflow, max_span]),
            (tidx.to(torch.int32), wrow_w[tidx].to(torch.int32), wide_ovf))


def _check_explicit_window(plan: JoinPlan, tile: int, window: int) -> None:
    """Refuse an explicit window past the ceiling of the kernel it
    resolves to (_merge_impl's rule), with the JAX package's caps, and
    warn when a wide window falls through to the window hash table
    (K2)."""
    rows = max(1, tile // 128)
    w_chunks = -(-window // 128)
    forced = plan.probe_impl
    if forced == "merge_jnp":
        return
    to_gather = (
        forced == "merge_gather"
        or (forced == "merge"
            and GATHER_MIN_CHUNKS <= w_chunks <= GATHER_MAX_CHUNKS)
    )
    if to_gather:
        cap = min(GATHER_MAX_CHUNKS, GATHER_ROWCHUNK_BUDGET // rows) * 128
        if window > cap:
            raise ValueError(
                f"window={window} exceeds the gather probe's ceiling {cap} "
                f"at tile {tile} ({GATHER_ROWCHUNK_BUDGET} rowchunks, "
                f"{GATHER_MAX_CHUNKS} chunks): shrink the tile or window"
            )
        return
    cap = (DENSE_ROWCHUNK_BUDGET // rows) * 128
    if window > cap:
        raise ValueError(
            f"window={window} resolves to K2 (the window hash table) and "
            f"exceeds its ceiling {cap} at tile {tile} "
            f"({DENSE_ROWCHUNK_BUDGET} rowchunks, the TPU kernel's budget "
            "kept for parity): shrink the tile or the window, or keep the "
            f"window within the gather band (<= {GATHER_MAX_CHUNKS * 128})"
        )
    if forced == "merge" and w_chunks > GATHER_MAX_CHUNKS:
        warnings.warn(
            f"explicit window={window} ({w_chunks} chunks) is past the "
            f"gather band's {GATHER_MAX_CHUNKS}-chunk cap and falls through "
            "to K2, the window hash table, which takes a round for every "
            "stage of live window slots",
            stacklevel=3,
        )


def _merge_impl(plan: JoinPlan, window: int) -> str:
    """Resolve 'merge' to a probe: the window hash table (K2) for windows
    under GATHER_MIN_CHUNKS or over GATHER_MAX_CHUNKS chunks, the
    staged-window search (K3) in between.  Explicit values are
    honoured; 'merge_jnp' runs the plain version and exists for tests."""
    if plan.probe_impl == "merge":
        if GATHER_MIN_CHUNKS * 128 <= window <= GATHER_MAX_CHUNKS * 128:
            return "merge_gather"
        return "merge_pallas"
    return plan.probe_impl


_PROBES = {
    "merge_gather": merge_probe_gather,
    "merge_pallas": merge_probe,
    "merge_jnp": merge_probe_torch,
}


def _merge_probe(bhk, bval, ohk, ov, wrow, overflow, plan: JoinPlan,
                 tile: int, window: int, wide=None) -> JoinResult:
    """The window probe at `window`; with `wide` (the two-class
    geometry, _merge_windows' third value) the wide pass K4 follows.
    Under "merge_jnp" one plain pass at window_wide stands for both (the
    JAX package's oracle: a lower anchor with a wider window is exact
    for every tile)."""
    impl = _merge_impl(plan, window)
    try:
        probe = _PROBES[impl]
    except KeyError:
        raise ValueError(f"unknown merge probe_impl {impl!r}") from None
    # third statistic: plan-optimization violations: wide tiles past
    # wide_cap, and (below) unique_build duplicates
    viol = overflow.new_zeros(())
    # the probe's sorted chunks order the kernels' blocks, nothing else
    chunks = plan.probe_chunks
    if wide is not None and impl == "merge_jnp":
        mv, mc = probe(ohk, bhk, bval, wrow, tile, plan.window_wide, chunks)
    else:
        mv, mc = probe(ohk, bhk, bval, wrow, tile, window, chunks)
    if wide is not None:
        tidx, wrow_c, wide_ovf = wide
        if impl != "merge_jnp":
            mv, mc = merge_probe_gather_indexed(ohk, bhk, bval, wrow_c, tidx,
                                                mv, mc, tile,
                                                plan.window_wide, chunks)
        viol = viol + wide_ovf
    # the gather probe's max value relies on value-ordered runs, so a
    # unique_build plan whose build side has adjacent equal keys is
    # counted there and join() downgrades it (the JAX package's rule,
    # kept for parity)
    if plan.unique_build and impl == "merge_gather":
        viol = viol + ((bhk[1:] == bhk[:-1]) & (bhk[1:] != BIAS)).sum()
    stats = torch.cat([overflow, viol[None]])
    return JoinResult(_unscramble(ohk, plan.factor), ov, mv, mc, stats)


def _staged_fns(plan: JoinPlan, tile: int, window: int, rows_total: int):
    """The merge pipeline's stages at a pinned geometry, as three
    functions: sort_side(keys, vals, pad_to, build=False) -> sorted
    (biased keys, values), the build side by (key, value) and the probe
    side by key in plan.probe_chunks chunks; windows(bhk, ohk) -> (wrow,
    stats, wide), wide None but for a two-class plan; probe(bhk, bval,
    ohk, ov, wrow, stats, wide) -> JoinResult.  phj_join_merge runs them
    once; the streaming driver (engine/stream.py) sorts the build side
    once and runs the probe stages per chunk, and takes new stages on
    each re-plan."""

    def sort_side(keys, vals, pad_to: int, build: bool = False):
        if build:
            return _merge_sort_side(keys, vals, pad_to, plan.factor)
        return _merge_sort_probe(keys, vals, pad_to, plan.probe_chunks,
                                 plan.factor)

    def windows(bhk, ohk):
        if not plan.window_wide:
            return (*_merge_windows(bhk, ohk, tile, window, rows_total),
                    None)
        wcap = plan.wide_cap or max(8, ohk.shape[0] // tile // 16)
        return _merge_windows(bhk, ohk, tile, window, rows_total,
                              window_wide=plan.window_wide, wide_cap=wcap)

    def probe(bhk, bval, ohk, ov, wrow, stats, wide):
        return _merge_probe(bhk, bval, ohk, ov, wrow, stats, plan, tile,
                            window, wide)

    return sort_side, windows, probe


def _untimed(name, fn, *args, **kw):
    return fn(*args, **kw)


def phj_join_merge(inner_keys, inner_vals, outer_keys, outer_vals,
                   plan: JoinPlan, timer=None) -> JoinResult:
    """PHJ, merge mode: partition == sort, probe == window probe.  Inputs
    are 1-D int32 tensors (uint32 bits) on one device; the result's
    build_counts is [window-overflow tile count, max required span,
    plan-opt violations] and must be all zero but the span to be
    complete.  A two-class plan whose wide window is wider than the build
    side is refused, as the JAX package refuses it (its window slice
    cannot exceed the build side).  With a `timer` (utils/timing.py
    PhaseTimer) the four stages run as its phases
    (phj_join_merge_staged)."""
    run = _untimed if timer is None else timer.run
    ni, no = inner_keys.shape[0], outer_keys.shape[0]
    tile, window, rows_total, cap = _merge_params(plan, ni, no)
    if plan.window_wide > rows_total * 128:
        raise ValueError(
            f"window_wide={plan.window_wide} is wider than the build side "
            f"({rows_total * 128} slots): use a single-class plan"
        )
    sort_side, windows, probe = _staged_fns(plan, tile, window, rows_total)
    bhk, bval = run("partition_build", sort_side, inner_keys, inner_vals,
                    rows_total * 128, True)
    ohk, ov = run("partition_probe", sort_side, outer_keys, outer_vals, cap)
    wrow, stats, wide = run("windows", windows, bhk, ohk)
    return run("probe", probe, bhk, bval, ohk, ov, wrow, stats, wide)


def phj_join_merge_staged(inner_keys, inner_vals, outer_keys, outer_vals,
                          plan: JoinPlan, timer) -> JoinResult:
    """The merge pipeline as four separately timed stages
    (partition_build / partition_probe / windows / probe), the TIMELOG
    analog (phj.cpp:1712-1927): phase boundaries land in
    timer.timeline, per-phase seconds in timer.phases.  The same stages
    as phj_join_merge, so the result is equal slot for slot; each stage
    boundary adds a device synchronize.  The geometry is pinned: a
    window overflow is counted in build_counts, not re-planned."""
    return phj_join_merge(inner_keys, inner_vals, outer_keys, outer_vals,
                          plan, timer)


def _padded_probe(plan: JoinPlan, pk, tk, tv, tpid, tile: int,
                  table_counts) -> tuple:
    """"auto" and "pallas" run ``probe_tiles`` (the kernel on a CUDA
    tensor, the plain version on a CPU tensor); "jnp" always runs the
    plain version with the table-count mask, and exists for tests."""
    if plan.probe_impl in ("auto", "pallas"):
        return probe_tiles(pk, tk, tv, tpid, tile)
    if plan.probe_impl == "jnp":
        return probe_tiles_torch(pk, tk, tv, tpid, tile, table_counts)
    raise ValueError(f"unknown probe_impl {plan.probe_impl!r}")


def _scrambled(keys, vals, factor: int):
    """Biased scrambled keys and the values, as flat columns (K1 with no
    padding)."""
    hk, v = flat_to_rows(keys, vals, keys.shape[0], 1, factor)
    return hk.view(-1), v.view(-1)


def _check_padded_plan(plan: JoinPlan) -> None:
    if plan.partition_impl not in ("sort", "argsort", "radix"):
        raise ValueError(f"unknown partition_impl {plan.partition_impl!r}")
    if plan.partition_impl == "radix" and sum(plan.pass_bits) != plan.p_bits:
        raise ValueError("radix mode consumes pass_bits; their sum must "
                         f"equal p_bits ({plan.pass_bits} vs {plan.p_bits})")


def _padded_build(keys, vals, plan: JoinPlan):
    """Build side of the padded path: (table keys (P, S), table values,
    partition counts (P,), pass overflow or None).  Sort modes pack a
    dense table of plan.slots per partition; radix mode's final regions
    are the table (null-interleaved: the probe never matches a null)."""
    P = plan.num_partitions
    hk, v = _scrambled(keys, vals, plan.factor)
    if plan.partition_impl == "radix":
        tk, tv, counts, ovf = multipass_partition(hk, v, plan.pass_bits,
                                                  plan.skip_bits)
        slots = tk.shape[0] // P
        return tk.view(P, slots), tv.view(P, slots), counts, ovf
    pid = pids_from_hk(hk, plan.p_bits, plan.skip_bits, null_pid=P)
    return (*build_dense_table(hk, v, pid, P, plan.slots), None)


def _padded_layout(keys, vals, plan: JoinPlan):
    """Probe side of the padded path: (keys, values, tile_pid, tile, pass
    overflow or None), every tile inside one partition's region.  Radix
    regions are 128-slot multiples and take a 128-slot tile."""
    P = plan.num_partitions
    hk, v = _scrambled(keys, vals, plan.factor)
    if plan.partition_impl == "radix":
        pk, pv, _, ovf = multipass_partition(hk, v, plan.pass_bits,
                                             plan.skip_bits)
        tile = 128
        offsets = torch.arange(P + 1, device=pk.device) * (pk.shape[0] // P)
    else:
        pid = pids_from_hk(hk, plan.p_bits, plan.skip_bits, null_pid=P)
        pk, pv, offsets, _ = partition_padded(hk, v, pid, P, plan.tile)
        tile, ovf = plan.tile, None
    return pk, pv, tile_pids(offsets, pk.shape[0] // tile, tile), tile, ovf


def _unscramble(pk, factor: int):
    """Original keys of a biased scrambled column (pads become 0)."""
    return mul_u32(unbias(pk), mod_inverse_u32(factor))


def _phj_join_padded(inner_keys, inner_vals, outer_keys, outer_vals,
                     plan: JoinPlan) -> JoinResult:
    """PHJ, padded mode: the JAX package's ``_phj_join_padded`` and
    ``_phj_join_padded_radix``.  Null keys are dropped on both sides.
    build_counts holds the P build partition counts (a count past
    plan.slots means dropped tuples); radix mode appends the summed pass
    overflow of both sides (P+1 entries)."""
    _check_padded_plan(plan)
    tk, tv, bcounts, bovf = _padded_build(inner_keys, inner_vals, plan)
    pk, pv, tpid, tile, oovf = _padded_layout(outer_keys, outer_vals, plan)
    counts = bcounts
    if bovf is not None:
        counts = torch.full_like(bcounts, tk.shape[1])
        bcounts = torch.cat([bcounts, (bovf + oovf).view(1)])
    mv, mc = _padded_probe(plan, pk, tk, tv, tpid, tile, counts)
    return JoinResult(_unscramble(pk, plan.factor), pv, mv, mc, bcounts)


def phj_join(inner_keys, inner_vals, outer_keys, outer_vals,
             plan: JoinPlan) -> JoinResult:
    """Dispatch on the plan's probe mode: "merge*" runs the sorted-window
    probe, every other mode the padded-partition path."""
    if plan.probe_impl.startswith("merge"):
        return phj_join_merge(inner_keys, inner_vals, outer_keys,
                              outer_vals, plan)
    return _phj_join_padded(inner_keys, inner_vals, outer_keys, outer_vals,
                            plan)


def downgrade_plan_opts(plan: JoinPlan) -> JoinPlan:
    """Re-plan response to a counted plan-optimization violation
    (build_counts[2]): drop the opportunistic flags, and collapse a
    two-class plan to one class at window_wide (the exact form); tile and
    chunks unchanged."""
    kw = {}
    if plan.window_wide:
        kw = dict(window=plan.window_wide, window_wide=0, wide_cap=0)
    return dataclasses.replace(plan, gather_select="flat",
                               unique_build=False, **kw)


def window_from_span(span: int) -> int:
    """128-aligned window for a measured max span: 25% slack plus a
    384-slot floor pad.  Not clamped; callers compare with their cap."""
    return -(-int(max(span, 128) * 1.25 + 384) // 128) * 128


def replan_window_cap(tile: int = 3072) -> int:
    """Largest auto or re-planned window at this tile: the gather band's
    cap three chunks below the JAX package's TPU compile limits (kept for
    parity, see the constants above)."""
    rows = max(1, tile // 128)
    chunks = min(GATHER_MAX_CHUNKS, GATHER_ROWCHUNK_BUDGET // rows)
    return max(3, chunks - 3) * 128


def replan_from_span(plan: JoinPlan, span: int) -> JoinPlan:
    """Next plan after a window overflow, sized from the measured max
    span.  Spans scale with tile * probe_chunks, so when even the padded
    span busts the cap the tile shrinks first (down to 512), then the
    chunk count; the new window lands strictly under the cap.  A
    two-class plan first collapses to one class at window_wide (even
    the wide window missed a span)."""
    if plan.window_wide:
        plan = dataclasses.replace(plan, window=plan.window_wide,
                                   window_wide=0, wide_cap=0)
    cap = replan_window_cap(plan.tile)
    span = max(int(span), 128)
    C = max(1, plan.probe_chunks)
    want = window_from_span(span)
    if want > cap:
        product = plan.tile * C
        prod_fit = int(product * (cap - 511) / (1.25 * span))
        tile_new = max(128, prod_fit // C // 128 * 128)
        if tile_new >= 512:
            span_est = span * tile_new * C / product
            want = min(replan_window_cap(tile_new),
                       window_from_span(span_est))
            return dataclasses.replace(plan, tile=tile_new, window=want)
        newC = max(1, int(C * (cap - 511) / (1.25 * span)))
        want = min(cap, window_from_span(span * newC / C))
        return dataclasses.replace(plan, probe_chunks=newC, window=want)
    return dataclasses.replace(plan, window=want)


def _run_device(device) -> torch.device:
    """`device`, or by default the card (RuntimeError where there is
    none: the entry points never carry on on the host unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for numpy inputs: pass "
            "device='cpu' to run the plain versions on the host"
        )
    return torch.device("cuda")


def _as_column(x, device) -> torch.Tensor:
    """A join input as a contiguous 1-D int32 bit tensor.  A tensor stays
    on its device unless `device` is given; a numpy column goes to
    `device`, by default the card (RuntimeError where there is none)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError("tensor columns must be 1-D int32 (uint32 bits)")
        return (x if device is None else x.to(device)).contiguous()
    return u32_to_device(np.asarray(x), _run_device(device))


def join(inner_keys, inner_vals, outer_keys, outer_vals,
         plan: JoinPlan | None = None, window_retries: int = 3,
         device=None) -> tuple[JoinResult, JoinPlan]:
    """Join with automatic window re-planning.

    Columns are 1-D int32 tensors holding uint32 bits, on the device to
    run on, or numpy uint32 arrays, which go to ``device`` (by default
    the card; ``device="cpu"`` runs the plain versions).  In the merge modes
    a counted window overflow re-plans from the measured span
    (replan_from_span), and a counted plan-optimization violation
    downgrades the plan's flags (downgrade_plan_opts).  In the padded
    modes an overflow (a build partition past plan.slots, or a radix pass
    past its region capacity) drops tuples and cannot be re-planned: it
    raises RuntimeError.  Returns (result, final plan)."""
    cols = [_as_column(c, device) for c in
            (inner_keys, inner_vals, outer_keys, outer_vals)]
    if len({c.device for c in cols}) != 1:
        raise ValueError("all four columns must be on one device")
    if plan is None:
        plan = plan_join(cols[0].shape[0], cols[2].shape[0],
                         device=cols[0].device)
    res = phj_join(*cols, plan)
    if not plan.probe_impl.startswith("merge"):
        bc = res.build_counts
        over = (bool(bc[-1] != 0) if plan.partition_impl == "radix"
                else bool((bc > plan.slots).any()))
        if over:
            raise RuntimeError(
                "local join overflow on the padded path (table slots or "
                "radix pass capacity exceeded): raise plan.slots or the "
                "pass fanout; window re-planning cannot fix this"
            )
        return res, plan
    for _ in range(window_retries):
        win_ovf, span, sel_ovf = res.build_counts.tolist()
        if win_ovf == 0 and sel_ovf == 0:
            break
        res = None  # free the failed attempt before retrying
        if sel_ovf:
            plan = downgrade_plan_opts(plan)
        if win_ovf:
            plan = replan_from_span(plan, span)
        res = phj_join(*cols, plan)
    else:
        win_ovf, _, sel_ovf = res.build_counts.tolist()
        if win_ovf or sel_ovf:
            raise RuntimeError(
                "probe window overflow persists after re-planning"
            )
    return res, plan


def materialize(res: JoinResult):
    """Matched rows as host (keys, vals, tabs) numpy uint32 arrays.
    Requires match counts <= 1 (unique build keys); for duplicate-key
    builds use materialize_expanded.  An empty result gives three empty
    arrays, as the JAX package's max(initial=0) does."""
    mc = res.match_cnts
    if mc.numel() and int(mc.max()) > 1:
        raise ValueError(
            "multi-match rows present; use materialize_expanded"
        )
    m = mc == 1
    return (to_numpy_u32(res.probe_keys[m]), to_numpy_u32(res.probe_vals[m]),
            to_numpy_u32(res.match_vals[m]))


def materialize_expanded(res: JoinResult, inner_keys, inner_vals,
                         block_rows: int = 0):
    """Full M:N materialization: every (probe row, matching build row)
    pair, for builds with duplicate keys.

    The aligned result carries exact per-probe match counts; the rows
    come from the expansion (ops/expand.py) of the matched probe rows
    against the build relation (`inner_keys`, `inner_vals`: numpy uint32
    or int32 bit tensors), on the result's device.  Returns (keys, vals,
    tabs) host uint32 arrays of exactly sum(match_cnts) rows; an empty
    result gives three empty arrays.

    block_rows > 0 streams the expansion through blocks of consecutive
    matched probe rows whose output fits `block_rows` (auto-raised to
    the largest single-row multiplicity; ops/expand.py greedy_blocks),
    with the outputs concatenated on the host: the form for expansions
    larger than device memory.  The JAX package pads every block to one
    capacity so one compiled program serves them all; here a block
    expands at its own size, and the rows are the same."""
    from ..ops.expand import (
        build_side,
        expand_join,
        greedy_blocks,
        matched_rows,
    )

    pk, pv, counts = matched_rows(res)
    total = int(counts.sum())
    if total == 0:
        e = np.zeros(0, np.uint32)
        return e, e.copy(), e.copy()
    ik, iv = build_side(inner_keys, inner_vals, pk.device)
    if not block_rows or total <= block_rows:
        blocks = [(0, len(counts), total)]
    else:
        blocks = greedy_blocks(counts, max(block_rows, int(counts.max())))
    outs = []
    for start, stop, blk_total in blocks:
        got, *cols = expand_join(ik, iv, pk[start:stop], pv[start:stop],
                                 blk_total)
        if int(got) != blk_total:
            raise RuntimeError(f"expansion gave {int(got)} rows for a "
                               f"block of {blk_total} matches")
        outs.append([to_numpy_u32(c) for c in cols])
    return tuple(np.concatenate(c) for c in zip(*outs))
