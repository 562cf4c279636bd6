"""Smoke run of the PyTorch/CUDA port (hash_join_codes_knl_tpu_torch) on
one NVIDIA GPU: build the kernels, hold each against its plain PyTorch
version (the indexed wide-window probe K4 also on a headline-sized tile
list, against the wide-window probe K3 over all tiles), then drive the
three paths of the port.  The merge path of
join(): digests against the numpy oracle, the 16M x 256M headline join,
its Zipf z=1.0 twin and the two-class window geometry on the same
columns.  The padded path (sort-mode and radix-partitioned PHJ): digests
against the oracle, then 16M x 256M in sort mode and in the 4096-way
radix mode.  The NPJ path (npj_join): digests against the oracle, then
4M x 16M and 16M x 256M in both output orders, then the dense window
probe alone on the 16M x 256M table.

    python3 chip_smoke.py

Needs a CUDA device, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and g++
(the port's native relation generator).  Imports nothing of the JAX
package.  Every check raises on failure; the exit code is 0 only when
all phases passed.  The last line of standard output is one JSON object
naming the device; the line before it lists every kernel with its
launch count in the path runs, its largest difference from the plain
version, its time, the plain version's, and its bound: the larger of
its bytes over 3.35 TB/s and its operations over the 32-bit integer rate
INT32_OPS_PER_S (one H100 SXM's published peaks).  The radix pass is also
run once under torch.profiler and split into its kernels.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

HEADLINE = (16_000_000, 256_000_000)  # bench.py's shape
HEADLINE_4M = (4_000_000, 64_000_000)  # the digest check's shape
RADIX_4M = (4_000_000, 16_000_000)  # the phj_radix_4096way bench row
SMALL = (1_000_000, 8_000_000)  # the dense probe's and sort mode's shape
# the TPU engine's hardware battery relation (scripts/tpu_smoke.py):
# build keys unique among 400K draws, probe hits drawn from them, misses
BATTERY = (400_000, 262_144, 3_000_000, 500_000)
NPJ_4M = (4_000_000, 16_000_000)  # the npj_uniform bench row's shape

# one H100 SXM at its 700 W limit: device memory rate, and the 32-bit
# integer rate (132 SMs x 64 INT32 lanes x 1.98 GHz; the float32 rate of
# 67 TFLOP/s counts 128 lanes and two operations per FMA)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _bound(nbytes: float, ops: float = 0.0) -> dict:
    """bound_ms and bound_by for a kernel call that must move `nbytes`
    (each input read once, each output written once) and do `ops` 32-bit
    integer operations (compares)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def _live(hk) -> int:
    return int((hk != -2**31).sum())


def _window_union(wrow, window: int, n_build: int) -> int:
    """Build slots in the union of the windows anchored at `wrow` (the
    kernels' clamp of each start)."""
    starts = torch.sort((wrow.long() * 128).clamp(
        0, max(0, n_build - window))).values
    return (int((starts[1:] - starts[:-1]).clamp(max=window).sum())
            + window if starts.numel() else 0)


def _table_bound(probe, wrow, window: int, n_build: int) -> dict:
    """Bound of the dense window probe (K2) over the probe slots `probe`:
    the probes and anchors read, the union of the windows read once (keys
    and values), both outputs written.  The function needs one lookup a
    probe, so there is no compare term: the TPU kernel's all-pairs sweep
    is that design's work, not the function's."""
    return _bound(12 * probe.numel() + 4 * wrow.numel()
                  + 8 * _window_union(wrow, window, n_build))


def _search_bound(probe, wrow, window: int, n_build: int, mc,
                  entry_bytes: int = 4) -> dict:
    """Bound of a sorted-window probe (K3, K4) over the probe slots
    `probe`, one window per entry of `wrow` (entry_bytes read per entry:
    the anchor, and K4's tile id): the probes read, the build keys of the
    union of the windows read once, one build value per matched probe
    (val[hi - 1]; mc is the call's counts), both outputs written; two
    searches of ceil(log2(window)) compares per live probe."""
    nbytes = (12 * probe.numel() + entry_bytes * wrow.numel()
              + 4 * _window_union(wrow, window, n_build)
              + 4 * int((mc > 0).sum()))
    return _bound(nbytes, 2 * _live(probe) * max(1, (window - 1).bit_length()))


def _radix_4096_plan():
    """The reference CPRA's 4096-way fanout as two 6-bit passes (the
    phj_radix_4096way bench row's plan)."""
    from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan

    return JoinPlan(p_bits=12, slots=1024, tile=2048, pass_bits=(6, 6),
                    partition_impl="radix", probe_impl="pallas")


def _sort_plan(ni, no):
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join

    return dataclasses.replace(plan_join(ni, no), probe_impl="pallas")


def _ptxas_report(text: str) -> list:
    """(kernel, "registers, barriers, shared memory; stack and spills")
    for every kernel in nvcc's -Xptxas -v output (empty when the library
    came from the cache)."""
    out, kernel, spills = [], None, ""
    for line in text.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            # a kernel templated on one bool is named kernel<false|true>
            m = re.search(r"([a-z_]+_kernel)(ILb([01])E)?E", line)
            kernel = line.split("'")[1] if not m else m.group(1) + (
                "" if m.group(3) is None
                else ("<true>" if m.group(3) == "1" else "<false>"))
        elif "spill" in line:
            spills = line
        elif "registers" in line and kernel:
            out.append((kernel, f"{line.split(':', 1)[1].strip()}; {spills}"))
            kernel = None
    return out


def _print(*a):
    print(*a, flush=True)


_T0 = time.perf_counter()


def _stamp(done: str) -> None:
    """Wall-clock seconds since the script started, after a phase."""
    _print(f"elapsed: {time.perf_counter() - _T0:.1f} s after {done}")


def _median_ms(fn, reps: int) -> float:
    """Median device time of fn() in ms, from CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _queued_ms(fn, calls: int = 20) -> float:
    """Device time of one fn() in ms: `calls` calls queued behind a kernel
    that sleeps 2e8 cycles (about 0.1 s), so the host work of every call
    is done before the device reaches them and the CUDA events around
    them time the device alone; their time over the count.  Raises if the
    host took longer than the sleep.  For a call whose kernel is shorter
    than the wrapper's host work, where _median_ms times the host too."""
    fn()  # warm-up
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(200_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ev[2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise AssertionError(f"{calls} calls took {host_ms:.3f} ms on the "
                             f"host, longer than the device's sleep")
    return ev[1].elapsed_time(ev[2]) / calls


def _max_abs_err(got, want) -> int:
    """Largest absolute difference over the output tensors (int64)."""
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def _check_equal(name, got, want):
    if got[0].is_cuda:
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err "
                                 f"{_max_abs_err(got, want)})")


def _device_cols(rel_pair, dev):
    from hash_join_codes_knl_tpu_torch.engine.convert import (
        relation_to_device,
    )

    inner, outer = rel_pair
    return (*relation_to_device(inner, dev), *relation_to_device(outer, dev))


def _generate(ni, no, **kw):
    from hash_join_codes_knl_tpu_torch import native
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate

    if not native.available():
        raise RuntimeError("the native relation generator did not build "
                           "(g++ missing?); the Python one is far too slow "
                           "at these sizes")
    t0 = time.perf_counter()
    inner, outer, _ = generate(inner_tuples=ni, outer_tuples=no, **kw)
    return (inner, outer), time.perf_counter() - t0


def _oracle_digest(data):
    """join_oracle's digest of a relation pair (numpy, host only)."""
    from hash_join_codes_knl_tpu_torch.engine.oracle import (
        join_oracle,
        multiset_digest,
    )

    inner, outer = data
    return multiset_digest(*join_oracle(inner.keys, inner.vals, outer.keys,
                                        outer.vals))


def _start_oracles(data_1m) -> dict:
    """The digest cases: name -> (relation pair, a future of its oracle
    digest).  The relations are generated here; their digests are
    computed on two host threads (numpy releases the interpreter lock)
    while the caller joins the same relations on the card and digests
    the results.  The threads end with their work; a failure there is
    raised where the result is read."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    cases = {"small": (data_1m, pool.submit(_oracle_digest, data_1m))}
    for name, shape, kw in (
            ("uniform_4m", HEADLINE_4M, dict(seed=42, mode="uniform")),
            ("zipf_4m", HEADLINE_4M, dict(seed=43, mode="zipf", zipf=1.0)),
            ("radix_4m", RADIX_4M, dict(seed=44, mode="uniform"))):
        data, _ = _generate(*shape, **kw)
        cases[name] = (data, pool.submit(_oracle_digest, data))
    pool.shutdown(wait=False)  # the submitted work still runs to its end
    return cases


def _stages(cols, plan):
    """Sorted inputs of the probe at this plan, through the engine's own
    stages: (bhk, bval, ohk, ov, wrow, tile, window)."""
    from hash_join_codes_knl_tpu_torch.engine import phj

    ik, iv, ok, ov = cols
    tile, window, rows, cap = phj._merge_params(plan, ik.shape[0],
                                                ok.shape[0])
    bhk, bval = phj._merge_sort_side(ik, iv, rows * 128, plan.factor)
    ohk, ov_s = phj._merge_sort_probe(ok, ov, cap, plan.probe_chunks,
                                      plan.factor)
    wrow, stats = phj._merge_windows(bhk, ohk, tile, window, rows)
    if int(stats[0]):
        raise AssertionError(f"window overflow in the kernel inputs: "
                             f"{stats.tolist()}")
    return bhk, bval, ohk, ov_s, wrow, tile, window


def phase_kernels(dev, cols_1m, cols_h) -> dict:
    """Each kernel against its plain version, slot for slot, at a small
    shape and at the main path's shapes (1M x 8M for the dense probe, the
    16M x 256M headline for the others); median times of both."""
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.phj import _merge_params
    from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
    from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    out = {}
    g = torch.Generator(device=dev).manual_seed(7)

    def rand_i32(n):
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                             device=dev, generator=g)

    # K1: small, then C = 64 at a 64M cap, then the headline's probe side
    plan_h = plan_join(*HEADLINE)
    cap_h = _merge_params(plan_h, *HEADLINE)[3]
    for n, cap, C, k, v in (
        (1000, 1024, 8, rand_i32(1000), rand_i32(1000)),
        (64_000_000, 64 * 1_000_448, 64, rand_i32(64_000_000),
         rand_i32(64_000_000)),
        (HEADLINE[1], cap_h, plan_h.probe_chunks, cols_h[2], cols_h[3]),
    ):
        args = (k, v, cap, C, plan_h.factor)
        got, want = cl.flat_to_rows(*args), cl.flat_to_rows_torch(*args)
        _check_equal(f"flat_to_rows n={n} C={C}", got, want)
    err = _max_abs_err(got, want)
    ms = _median_ms(lambda: cl.flat_to_rows(*args), 20)
    plain_ms = _median_ms(lambda: cl.flat_to_rows_torch(*args), 5)
    # keys and values read, both padded columns written
    out["flat_to_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               **_bound(8 * n + 8 * cap),
                               shape=f"n={n} cap={cap} C={C}")
    _print(f"phase kernels: flat_to_rows equal at n=1000 C=8, n=64M C=64 "
           f"and the headline's n={n} cap={cap} C={C}; kernel {ms:.4f} ms, "
           f"plain {plain_ms:.4f} ms at the last")

    # K2: the dense probe at the 1M x 8M plan (tile 2048, window 1024)
    plan_s = plan_join(*SMALL)
    s = _stages(cols_1m, plan_s)
    bhk, bval, ohk, _, wrow, tile, window = s
    small = (ohk[: 16 * tile], bhk, bval, wrow[:16], tile, window)
    _check_equal("merge_probe small", mp.merge_probe(*small),
                 mp.merge_probe_torch(*small))
    full = (ohk, bhk, bval, wrow, tile, window, max(1, plan_s.probe_chunks))
    got, want = mp.merge_probe(*full), mp.merge_probe_torch(*full)
    _check_equal("merge_probe", got, want)
    ms = _median_ms(lambda: mp.merge_probe(*full), 20)
    plain_ms = _median_ms(lambda: mp.merge_probe_torch(*full), 3)
    cap = ohk.shape[0]
    geo = mp.window_table_geometry(window, tile, cap // tile)
    out["merge_probe"] = dict(
        max_abs_err=_max_abs_err(got, want), ms=ms, plain_ms=plain_ms,
        **_table_bound(ohk, wrow, window, bhk.shape[0]),
        shape=f"probes={cap} tile={tile} window={window}")
    _print(f"phase kernels: merge_probe equal at 16 tiles and all "
           f"{ohk.shape[0] // tile} tiles, tile {tile}, window {window}, "
           f"{plan_s.probe_chunks} chunks ({geo}); kernel {ms:.4f} ms, "
           f"plain {plain_ms:.4f} ms")

    # K3: the staged-window search at the headline plan (tile 3072, window
    # 15104).  The plain version's compares scale with tile x window, so
    # kernel and plain are timed on 256 tiles spread over every chunk; the
    # kernel also runs in full and is held against the dense kernel there.
    del s, small, full, got, want
    bhk, bval, ohk, _, wrow, tile, window = _stages(cols_h, plan_h)
    n_tiles = ohk.shape[0] // tile
    sel = torch.linspace(0, n_tiles - 1, 256, device=dev).long()
    sub = (ohk.view(n_tiles, tile)[sel].reshape(-1).contiguous(), bhk,
           bval, wrow[sel].contiguous(), tile, window)
    got, want = mg.merge_probe_gather(*sub), mg.merge_probe_torch(*sub)
    _check_equal("merge_probe_gather", got, want)
    err = _max_abs_err(got, want)
    bound = _search_bound(sub[0], sub[3], window, bhk.shape[0], got[1])
    ms = _median_ms(lambda: mg.merge_probe_gather(*sub), 20)
    plain_ms = _median_ms(lambda: mg.merge_probe_torch(*sub), 3)
    # all tiles in the engine's block order over the plan's chunks
    full = (ohk, bhk, bval, wrow, tile, window, plan_h.probe_chunks)
    got = mg.merge_probe_gather(*full)
    _check_equal("merge_probe_gather vs merge_probe, full", got,
                 mp.merge_probe(*full))
    bound_full = _search_bound(ohk, wrow, window, bhk.shape[0], got[1])
    ms_full = _median_ms(lambda: mg.merge_probe_gather(*full), 10)
    # K4 where it has work: a headline-sized tile list, checked against
    # K3's output over all tiles
    out["k4_headline"] = _kernel_indexed_headline(ohk, bhk, bval, wrow, tile,
                                                  window, got,
                                                  plan_h.probe_chunks)
    # K2 on the same tiles: data for the gather band's dispatch constants
    ms_dense = _median_ms(lambda: mp.merge_probe(*full), 5)
    out["merge_probe"].update(
        ms_headline_tiles=ms_dense, bound_ms_headline_tiles=_table_bound(
            ohk, wrow, window, bhk.shape[0])["bound_ms"])
    out["merge_probe_gather"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, ms_full=ms_full,
        bound_ms_full=bound_full["bound_ms"], **bound,
        shape=f"256 of {n_tiles} tiles, tile={tile} window={window}")
    _print(f"phase kernels: merge_probe_gather equal to plain on 256 of "
           f"{n_tiles} tiles and to merge_probe on all, tile {tile}, "
           f"window {window}, {plan_h.probe_chunks} chunks, geometry "
           f"{mg.gather_geometry(window, tile)}; kernel {ms:.4f} ms, plain "
           f"{plain_ms:.4f} ms (256 tiles); kernel {ms_full:.4f} ms on all "
           f"tiles (bound {bound_full['bound_ms']:.4f} ms); merge_probe "
           f"{ms_dense:.4f} ms on all tiles")
    del bhk, bval, ohk, wrow, sub, full, got, want
    torch.cuda.empty_cache()
    out["probe_tiles"] = _kernel_probe_tiles(dev, cols_h)
    torch.cuda.empty_cache()
    out["radix_partition"] = _kernel_radix_partition(cols_h)
    return out


# K4's headline-sized list takes every 16th tile of the merge layout:
# the engine's default wide_cap, tiles // 16 (engine/phj.py)
K4_HEADLINE_STRIDE = 16


def _kernel_indexed_headline(ohk, bhk, bval, wrow, tile: int, window: int,
                             k3, chunks: int) -> dict:
    """K4 on a headline-sized list: every K4_HEADLINE_STRIDE-th tile of
    the 16M x 256M merge layout, in ascending order, at the layout's own
    window from anchors wrow[t] (already clamped for it), its blocks over
    the plan's `chunks` as the engine calls it.  Held exactly against its
    plain version on 256 of the entries, and on every listed tile against
    k3, K3's output over all tiles at the same window and anchors (the
    same function); then timed with CUDA events (median of 10) and as
    calls queued behind a sleeping kernel (_queued_ms), beside its
    bound.  Runs outside the counted path
    runs."""
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    n_tiles = ohk.shape[0] // tile
    tidx = torch.arange(0, n_tiles, K4_HEADLINE_STRIDE, dtype=torch.int32,
                        device=ohk.device)
    ids = tidx.long()
    wc = wrow[ids].contiguous()
    n = tidx.shape[0]
    sel = torch.linspace(0, n - 1, 256, device=ohk.device).long()

    def args(ti, anchors):  # onto fresh zero outputs
        return (ohk, bhk, bval, anchors, ti, torch.zeros_like(ohk),
                torch.zeros_like(ohk), tile, window)

    sub = (tidx[sel].contiguous(), wc[sel].contiguous())
    got = mg.merge_probe_gather_indexed(*args(*sub), chunks)
    want = mg.merge_probe_gather_indexed_torch(*args(*sub))
    _check_equal(f"merge_probe_gather_indexed, 256 of the {n}-entry "
                 f"headline list", got, want)
    err = _max_abs_err(got, want)
    del got, want
    full = args(tidx, wc)
    mv, mc = mg.merge_probe_gather_indexed(*full, chunks)
    _check_equal(f"merge_probe_gather_indexed vs merge_probe_gather on all "
                 f"{n} listed headline tiles",
                 [o.view(n_tiles, tile)[ids] for o in (mv, mc)],
                 [o.view(n_tiles, tile)[ids] for o in k3])
    bound = _search_bound(ohk.view(n_tiles, tile)[ids], wc, window,
                          bhk.shape[0], mc.view(n_tiles, tile)[ids], 8)
    ms = _median_ms(lambda: mg.merge_probe_gather_indexed(*full, chunks), 10)
    queued = _queued_ms(lambda: mg.merge_probe_gather_indexed(*full, chunks))
    _print(f"phase kernels: merge_probe_gather_indexed equal to plain on "
           f"256 of {n} entries (every {K4_HEADLINE_STRIDE}th of {n_tiles} "
           f"headline tiles, tile {tile}, window {window}, {chunks} chunks) "
           f"and to merge_probe_gather on all {n} listed tiles; kernel "
           f"{ms:.4f} ms on the whole list ({queued:.4f} ms queued), bound "
           f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return dict(max_abs_err_headline=err, ms_headline_list=ms,
                ms_headline_list_queued=queued,
                bound_ms_headline_list=bound["bound_ms"],
                entries_headline_list=n)


def _spread_tiles(pk, tpid, tile: int, count: int):
    """`count` tiles spread over the layout, in order (so their tile_pid
    stays non-decreasing), as a contiguous probe column; and their ids."""
    n_tiles = tpid.shape[0]
    sel = torch.linspace(0, n_tiles - 1, count, device=pk.device).long()
    return (pk.view(n_tiles, tile)[sel].reshape(-1).contiguous(),
            tpid[sel].contiguous(), sel)


def _check_full_probe(name, full, sel, want):
    """The kernel over a whole layout (a block per partition's tiles)
    agrees, on the spread tiles, with the run that was held against the
    plain version."""
    from hash_join_codes_knl_tpu_torch.ops import probe as pt

    got = pt.probe_tiles(*full)
    tile = full[4]
    _check_equal(name, [o.view(-1, tile)[sel].reshape(-1) for o in got],
                 want)


def _full_rows(tk, pk_s, tp_s, tile: int):
    """A copy of the table whose rows under the spread tiles have every
    slot live: a null slot takes a probe key of the row's tile (so build
    keys repeat, M:N) or, where that is null too, a key of its own.  A
    9216-slot row then holds more live slots than one round of the
    kernel's table."""
    slots = tk.shape[1]
    rows = tp_s.long()
    col = torch.arange(slots, device=tk.device)
    fill = pk_s.view(-1, tile)[:, col % tile]
    own = (rows[:, None] * slots + col[None, :] + 1).to(torch.int32)
    fill = torch.where(fill != -2**31, fill, own)
    out = tk.clone()
    out[rows] = torch.where(tk[rows] != -2**31, tk[rows], fill)
    return out


def _tile_probe_bound(pk, tk, tpid, tile: int) -> dict:
    """Bound of the tile probe over the probe column pk: probes and tile
    ids read once, the rows used read once (keys and values), both
    outputs written once; one table lookup per live probe."""
    rows_used = int(torch.unique(tpid).numel())
    return _bound(12 * pk.shape[0] + 4 * tpid.shape[0]
                  + 8 * tk.shape[1] * rows_used, _live(pk))


def _kernel_probe_tiles(dev, cols_h) -> dict:
    """The tile probe: a small case, then the sort-mode headline layout
    on 256 spread tiles (kernel and plain timed there), then the kernel
    alone on every tile of the sort-mode and the radix-4096 layouts."""
    from hash_join_codes_knl_tpu_torch.ops import probe as pt

    g = torch.Generator(device=dev).manual_seed(8)
    keys = torch.randint(-2**31 + 1, 2**31, (3000,), dtype=torch.int32,
                         device=dev, generator=g)
    ik = keys[torch.randint(0, 3000, (2000,), device=dev, generator=g)]
    ok = keys[torch.randint(0, 3000, (8192,), device=dev, generator=g)]
    ok[::9] = -2**31  # null probes
    small = _padded_stages(ik, ik, ok, ok, dataclasses.replace(
        _sort_plan(2000, 8192), p_bits=4, slots=256, tile=128))
    args = (small["pk"], small["tk"], small["tv"], small["tpid"], 128)
    _check_equal("probe_tiles small", pt.probe_tiles(*args),
                 pt.probe_tiles_torch(*args))

    plan = _sort_plan(*HEADLINE)
    lay = _padded_stages(*cols_h, plan)
    tile = plan.tile
    pk_s, tp_s, sel = _spread_tiles(lay["pk"], lay["tpid"], tile, 256)
    sub = (pk_s, lay["tk"], lay["tv"], tp_s, tile)
    got, want = pt.probe_tiles(*sub), pt.probe_tiles_torch(*sub)
    _check_equal("probe_tiles sort-mode headline, 256 tiles", got, want)
    err = _max_abs_err(got, want)
    ms = _median_ms(lambda: pt.probe_tiles(*sub), 20)
    plain_ms = _median_ms(lambda: pt.probe_tiles_torch(*sub), 3)
    bound = _tile_probe_bound(pk_s, lay["tk"], tp_s, tile)
    full = (lay["pk"], lay["tk"], lay["tv"], lay["tpid"], tile)
    _check_full_probe("probe_tiles sort-mode headline, all tiles", full, sel,
                      want)
    bound_sort = _tile_probe_bound(lay["pk"], lay["tk"], lay["tpid"],
                                   tile)["bound_ms"]
    n_sort = lay["tpid"].shape[0]
    ms_sort = _median_ms(lambda: pt.probe_tiles(*full), 5)
    del lay, full, sub, got, want
    torch.cuda.empty_cache()

    lay = _padded_stages(*cols_h, _radix_4096_plan())
    if int(lay["build_counts"][-1]):
        raise AssertionError("radix layout overflowed in phase kernels")
    pk_s, tp_s, sel = _spread_tiles(lay["pk"], lay["tpid"], 128, 256)
    sub = (pk_s, lay["tk"], lay["tv"], tp_s, 128)
    want = pt.probe_tiles_torch(*sub)
    _check_equal("probe_tiles radix-4096 headline, 256 tiles",
                 pt.probe_tiles(*sub), want)
    full = (lay["pk"], lay["tk"], lay["tv"], lay["tpid"], 128)
    _check_full_probe("probe_tiles radix-4096 headline, all tiles", full,
                      sel, want)
    # the same tiles against rows with every slot live: two rounds a row
    dense = (pk_s, _full_rows(lay["tk"], pk_s, tp_s, 128), lay["tv"], tp_s,
             128)
    want = pt.probe_tiles_torch(*dense)
    if int(want[1].max()) < 2:
        raise AssertionError("the full rows repeat no build key")
    _check_equal("probe_tiles radix-4096 rows with every slot live, 256 "
                 "tiles", pt.probe_tiles(*dense), want)
    _check_full_probe("probe_tiles radix-4096 rows with every slot live, "
                      "all tiles", (lay["pk"], dense[1], lay["tv"],
                                    lay["tpid"], 128), sel, want)
    del dense, want
    n_radix = lay["tpid"].shape[0]
    slots_radix = lay["tk"].shape[1]
    ms_radix = _median_ms(lambda: pt.probe_tiles(*full), 3)
    bound_radix = _tile_probe_bound(lay["pk"], lay["tk"], lay["tpid"],
                                    128)["bound_ms"]
    del lay, full, sub
    _print(f"phase kernels: probe_tiles equal to plain on a small layout and "
           f"on 256 spread tiles of the 16M x 256M sort-mode (tile {tile}, "
           f"{n_sort} tiles, slots {plan.slots}) and radix-4096 (tile 128, "
           f"{n_radix} tiles, slots {slots_radix}) layouts, the radix one "
           f"also with every row slot live (two table rounds a row), alone "
           f"and inside the run over all tiles; kernel "
           f"{ms:.4f} ms, plain {plain_ms:.4f} ms (256 sort-mode tiles); "
           f"kernel {ms_sort:.4f} ms on all sort-mode tiles, "
           f"{ms_radix:.4f} ms on all radix tiles")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                ms_full_sort=ms_sort, ms_full_radix=ms_radix,
                bound_ms_full_sort=bound_sort,
                bound_ms_full_radix=bound_radix, **bound,
                shape=f"256 of {n_sort} tiles, tile={tile} "
                      f"slots={plan.slots}")


def _kernel_radix_partition(cols_h) -> dict:
    """The radix pass at 256M probe rows: pass 1 of the 4096-way plan
    (F = 64), kernel and plain timed, then pass 2 over all 64 pass-1
    regions in one batched call."""
    from hash_join_codes_knl_tpu_torch.engine.phj import _scrambled
    from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp

    plan = _radix_4096_plan()
    hk, v = _scrambled(cols_h[2], cols_h[3], plan.factor)
    b1, b2 = plan.pass_bits
    args = (hk, v, b1)
    got, want = rp.radix_partition(*args), rp.radix_partition_torch(*args)
    _check_equal("radix_partition pass 1", got, want)
    err = _max_abs_err(got, want)
    if int(got[3]):
        raise AssertionError("radix pass 1 overflowed")
    del want
    ms = _median_ms(lambda: rp.radix_partition(*args), 10)
    plain_ms = _median_ms(lambda: rp.radix_partition_torch(*args), 3)
    split = radix_trace(args, f"pass 1 ({HEADLINE[1]} rows, F=64)")
    # keys and values read, the regions (keys and values) written
    bound = _bound(8 * hk.shape[0] + 8 * got[0].shape[0])
    del hk, v
    args2 = (got[0], got[1], b2, b1, 0, 32768, 1 << b1)
    got2, want2 = rp.radix_partition(*args2), rp.radix_partition_torch(*args2)
    _check_equal("radix_partition pass 2 batch", got2, want2)
    err = max(err, _max_abs_err(got2, want2))
    if int(got2[3]):
        raise AssertionError("radix pass 2 overflowed")
    del want2
    ms2 = _median_ms(lambda: rp.radix_partition(*args2), 5)
    split2 = radix_trace(args2, "pass-2 batch (64 regions, F=64)")
    n1, n2 = got[0].shape[0], got2[0].shape[0]
    _print(f"phase kernels: radix_partition equal to plain on pass 1 "
           f"({HEADLINE[1]} rows -> 64 regions, {n1} slots) and on the "
           f"pass-2 batch (64 regions of {n1 // 64} slots -> 4096 regions, "
           f"{n2} slots); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
           f"(pass 1); kernel {ms2:.4f} ms (pass 2 batch)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, ms_pass2=ms2,
                bound_ms_pass2=_bound(8 * n1 + 8 * n2)["bound_ms"],
                split_ms={k: round(x, 4) for k, x in split.items()},
                split_ms_pass2={k: round(x, 4) for k, x in split2.items()},
                **bound, shape=f"pass 1 of (6, 6): n={HEADLINE[1]} F=64")


def _wrappers() -> dict:
    """Every kernel wrapper by name; each counts its launches."""
    from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
    from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg
    from hash_join_codes_knl_tpu_torch.ops import probe as pt
    from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp

    return {"flat_to_rows": cl.flat_to_rows,
            "merge_probe": mp.merge_probe,
            "merge_probe_gather": mg.merge_probe_gather,
            "merge_probe_gather_indexed": mg.merge_probe_gather_indexed,
            "probe_tiles": pt.probe_tiles,
            "radix_partition": rp.radix_partition}


def _launches():
    return {k: fn.launches for k, fn in _wrappers().items()}


def _set_launches(counts=None):
    """Every wrapper's launch count to counts[name], or to 0."""
    for k, fn in _wrappers().items():
        fn.launches = counts[k] if counts else 0


def _delta(before):
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def _oracle_count(ik: np.ndarray, ok: np.ndarray) -> int:
    """Join cardinality from np.searchsorted over the sorted build keys
    (probe keys deduplicated first: skewed probes repeat a lot)."""
    sk = np.sort(ik)
    uk, reps = np.unique(ok, return_counts=True)
    per = (np.searchsorted(sk, uk, "right")
           - np.searchsorted(sk, uk, "left")).astype(np.int64)
    return int((per * reps).sum())


def _join_vs_oracle(label, data, dev, want_kernels, want, plan=None):
    """join() on the card against `want`, the oracle's digest of the
    same relations or a future of it; returns the final plan."""
    from hash_join_codes_knl_tpu_torch.engine.oracle import multiset_digest
    from hash_join_codes_knl_tpu_torch.engine.phj import join, materialize

    before = _launches()
    res, plan = join(*_device_cols(data, dev), plan)
    d = _delta(before)
    attempts = d["merge_probe"] + d["merge_probe_gather"]
    for k in want_kernels:
        if d[k] == 0:
            raise AssertionError(f"{label}: {k} was not launched ({d})")
    got = multiset_digest(*materialize(res))
    if isinstance(want, concurrent.futures.Future):
        want = want.result()  # computed beside the join, read after it
    if got != want:
        raise AssertionError(f"{label}: digest {got} != oracle {want}")
    replans = f"re-plans {attempts - 1}; " if attempts else ""
    _print(f"phase join: {label} digest equals the oracle's ({got[0]} rows); "
           f"{replans}launches {d}; final plan {plan}")
    return plan


def phase_joins(dev, oracles):
    from hash_join_codes_knl_tpu_torch.engine.phj import join

    data_1m, want = oracles["small"]
    _join_vs_oracle("uniform 1M x 8M", data_1m, dev, ["merge_probe"], want)
    data_4m, want = oracles.pop("uniform_4m")
    _join_vs_oracle("uniform 4M x 64M", data_4m, dev,
                    ["flat_to_rows", "merge_probe_gather"], want)
    del data_4m
    # one oracle digest serves both plans on the Zipf columns
    zipf, want = oracles.pop("zipf_4m")
    plan = _join_vs_oracle("zipf 1.0 4M x 64M", zipf, dev, [], want)
    two, qs, n_wide = _two_class_plan(_device_cols(zipf, dev), plan)
    final = _join_vs_oracle(
        f"zipf 1.0 4M x 64M two-class (tile spans p50/p90/p99/max {qs}, "
        f"{n_wide} wide tiles)", zipf, dev, ["merge_probe_gather_indexed"],
        want, two)
    if final != two:
        raise AssertionError(f"4M two-class join re-planned to {final}")
    del zipf
    # M:N: a 1M build over 250K distinct keys
    rng = np.random.default_rng(44)
    keys = rng.integers(1, 2**32, 250_000, dtype=np.uint32)
    ik = keys[rng.integers(0, keys.size, 1_000_000)]
    iv = rng.integers(0, 2**32, ik.size, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, ik.size, 6_000_000)],
                         rng.integers(1, 2**32, 2_000_000,
                                      dtype=np.uint32)])
    ov = rng.integers(0, 2**32, ok.size, dtype=np.uint32)
    res, plan = join(ik, iv, ok, ov, device=dev)
    got, want = int(res.join_tuples), _oracle_count(ik, ok)
    if got != want or int(res.match_cnts.max()) <= 1:
        raise AssertionError(f"M:N join: {got} matches, oracle {want}")
    _print(f"phase join: M:N 1M (250K distinct) x 8M: {got} matches equal "
           f"the oracle's; max multiplicity {int(res.match_cnts.max())}")


def phase_headline(dev, cols, gen_s) -> None:
    from hash_join_codes_knl_tpu_torch.engine.phj import join
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples

    torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    res, plan = join(*cols)
    d = _delta(before)
    got, want = int(res.join_tuples), expected_join_tuples(*HEADLINE)
    if got != want:
        raise AssertionError(f"headline: join_tuples {got} != {want}")
    if d["flat_to_rows"] == 0 or d["merge_probe_gather"] == 0:
        raise AssertionError(f"headline: K1/K3 not launched: {d}")
    del res
    med, runs = _median_s(lambda: join(*cols, plan))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _print(f"phase headline: 16M x 256M uniform, generation {gen_s:.3f} s "
           f"(host); join_tuples {got} exact; launches {d}; plan {plan}")
    _print(f"phase headline: join median of 3 {med:.6f} s = "
           f"{HEADLINE[1] / med:.1f} probe-tuples/s (runs {runs}); peak "
           f"device memory {peak:.2f} GiB")


def _stage_breakdown(cols, plan) -> dict:
    """Device time of each stage of one join at this plan, from CUDA
    events (the engine's stages run one by one, outside join())."""
    from hash_join_codes_knl_tpu_torch.engine import phj

    ik, iv, ok, ov = cols
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    tile, window, rows, cap = phj._merge_params(plan, ik.shape[0],
                                                ok.shape[0])
    ev[0].record()
    hk, v = phj.flat_to_rows(ik, iv, rows * 128, 1, plan.factor)
    ev[1].record()
    bhk, bval = phj._packed_sort(hk, v)
    ev[2].record()
    hk, v = phj.flat_to_rows(ok, ov, cap, max(1, plan.probe_chunks),
                             plan.factor)
    ev[3].record()
    ohk, ovs = phj._key_sort_rows(hk, v)
    del hk, v
    ev[4].record()
    wrow, overflow = phj._merge_windows(bhk, ohk, tile, window, rows)
    ev[5].record()
    res = phj._merge_probe(bhk, bval, ohk, ovs, wrow, overflow, plan, tile,
                           window)
    ev[6].record()
    res.join_tuples.item()
    ev[7].record()
    ev[7].synchronize()
    names = ["k1_build", "sort_build", "k1_probe", "sort_probe", "windows",
             "probe_and_unscramble", "count"]
    return {n: round(ev[i].elapsed_time(ev[i + 1]), 4)
            for i, n in enumerate(names)}


def phase_zipf_headline(dev):
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.phj import join

    data, gen_s = _generate(*HEADLINE, seed=42, mode="zipf", zipf=1.0)
    cols = _device_cols(data, dev)
    before = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, plan = join(*cols)
    got = int(res.join_tuples)
    dt = time.perf_counter() - t0
    d = _delta(before)
    del res
    want = _oracle_count(data[0].keys, data[1].keys)
    if got != want:
        raise AssertionError(f"zipf headline: {got} != oracle {want}")
    attempts = d["merge_probe"] + d["merge_probe_gather"]
    _print(f"phase zipf: 16M x 256M z=1.0, generation {gen_s:.3f} s; "
           f"join_tuples {got} equal the searchsorted count; {attempts - 1} "
           f"re-plans from {plan_join(*HEADLINE)} to final plan {plan}; "
           f"join incl. re-plans {dt:.6f} s")
    return cols, plan, want


def _two_class_plan(cols, plan):
    """The two-class plan for these columns, from the single-class plan
    that join() settled on: the per-tile spans at that plan (the anchors
    _merge_windows uses), the narrow window from the p90 span, the wide
    window the single-class one, and wide_cap the count of tiles past the
    narrow window rounded up to a multiple of 128.  Returns (plan, span
    quantiles p50/p90/p99/max, wide tile count).  Its sorts launch K1,
    which is set-up, not the path's: the launch counts are put back."""
    from hash_join_codes_knl_tpu_torch.engine import phj

    counts = _launches()
    ik, iv, ok, ov = cols
    tile, window, rows, cap = phj._merge_params(plan, ik.shape[0],
                                                ok.shape[0])
    bhk, _ = phj._merge_sort_side(ik, iv, rows * 128, plan.factor)
    ohk, _ = phj._merge_sort_probe(ok, ov, cap, plan.probe_chunks,
                                   plan.factor)
    _set_launches(counts)
    wrow_raw, hi_row = phj._window_rows(bhk, ohk, tile, rows)
    del bhk, ohk
    span = phj._anchored(wrow_raw, hi_row, window, rows)[1]
    qs = torch.quantile(span.double(), torch.tensor(
        [0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=span.device))
    qs = [int(q) for q in qs.tolist()]
    narrow = phj.window_from_span(qs[1])
    if narrow >= window:
        raise AssertionError(f"two-class: the p90 span's window {narrow} is "
                             f"not below the single-class window {window}")
    span = phj._anchored(wrow_raw, hi_row, narrow, rows)[1]
    n_wide = int((span > narrow).sum())
    two = dataclasses.replace(plan, window=narrow, window_wide=window,
                              wide_cap=max(128, -(-n_wide // 128) * 128))
    return two, qs, n_wide


def _median_s(fn):
    """Median host-clock seconds of 3 runs of fn(), each fenced by a
    synchronize (after the caller's checked warm-up run), and the runs."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    return float(np.median(times)), [round(t, 6) for t in times]


def phase_two_class(dev, cols, plan, want):
    """The two-class window geometry at 16M x 256M Zipf z=1.0, on the
    Zipf phase's columns: exact cardinality, no re-plan (the final plan
    keeps window_wide > 0), K4 launched; median of 3 beside the
    single-class join's at the same tile and chunks."""
    from hash_join_codes_knl_tpu_torch.engine.phj import join

    two, qs, n_wide = _two_class_plan(cols, plan)
    _print(f"phase two-class: tile spans at {plan}: p50/p90/p99/max {qs}; "
           f"narrow window {two.window} (p90), wide {two.window_wide}, "
           f"{n_wide} wide tiles, wide_cap {two.wide_cap}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    res, final = join(*cols, two)
    d = _delta(before)
    got = int(res.join_tuples)
    del res
    if got != want:
        raise AssertionError(f"two-class: join_tuples {got} != {want}")
    if final != two or not final.window_wide:
        raise AssertionError(f"two-class: re-planned to {final}")
    if d["merge_probe_gather_indexed"] == 0:
        raise AssertionError(f"two-class: K4 not launched: {d}")
    med2, runs2 = _median_s(lambda: join(*cols, two))
    peak2 = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    med1, runs1 = _median_s(lambda: join(*cols, plan))
    peak1 = torch.cuda.max_memory_allocated(dev) / 2**30
    _print(f"phase two-class: 16M x 256M z=1.0 join_tuples {got} equal the "
           f"searchsorted count; launches {d}; final plan {final}")
    _print(f"phase two-class: join median of 3 {med2:.6f} s (runs {runs2}), "
           f"peak {peak2:.2f} GiB; single-class at the same tile and chunks "
           f"{med1:.6f} s (runs {runs1}), peak {peak1:.2f} GiB; two-class / "
           f"single-class {med2 / med1:.4f}")
    return two, n_wide


def _kernel_indexed(dev, cols, two, n_wide) -> dict:
    """K4 against its plain version on 256 entries spread over the
    two-class layout's tile list (wide tiles, narrow pads, and 8 repeated
    entries), written onto the narrow pass's outputs; then K4's time on
    the whole wide pass.  Runs outside the counted path runs."""
    from hash_join_codes_knl_tpu_torch.engine import phj
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    ik, iv, ok, ov = cols
    tile, window, rows, cap = phj._merge_params(two, ik.shape[0],
                                                ok.shape[0])
    bhk, bval = phj._merge_sort_side(ik, iv, rows * 128, two.factor)
    ohk, _ = phj._merge_sort_probe(ok, ov, cap, two.probe_chunks, two.factor)
    wrow, stats, (tidx, wrow_c, wide_ovf) = phj._merge_windows(
        bhk, ohk, tile, window, rows, two.window_wide, two.wide_cap)
    if int(stats[0]) or int(wide_ovf):
        raise AssertionError(f"two-class layout overflowed: {stats.tolist()}"
                             f", wide past the cap {int(wide_ovf)}")
    narrow = phj._PROBES[phj._merge_impl(two, window)]
    mv0, mc0 = narrow(ohk, bhk, bval, wrow, tile, window)
    wide = two.window_wide
    n = tidx.shape[0]
    sel = torch.linspace(0, n - 1, 248, device=dev).long()
    sel = torch.cat([sel, sel[:8]])
    ti, wc = tidx[sel].contiguous(), wrow_c[sel].contiguous()

    def args(mv, mc):
        return (ohk, bhk, bval, wc, ti, mv, mc, tile, wide)

    def k4(*a):  # the blocks over the plan's chunks, as the engine runs it
        return mg.merge_probe_gather_indexed(*a, two.probe_chunks)

    got = k4(*args(mv0.clone(), mc0.clone()))
    want = mg.merge_probe_gather_indexed_torch(*args(mv0.clone(),
                                                     mc0.clone()))
    _check_equal("merge_probe_gather_indexed, 256 entries", got, want)
    err = _max_abs_err(got, want)

    def listed_bound(ids, anchors, mc):
        ids = ids.long()
        return _search_bound(ohk.view(-1, tile)[ids], anchors, wide,
                             bhk.shape[0], mc.view(-1, tile)[ids], 8)

    bound = listed_bound(ti, wc, got[1])
    del got, want
    mv, mc = mv0.clone(), mc0.clone()
    ms = _median_ms(lambda: k4(*args(mv, mc)), 20)
    queued = _queued_ms(lambda: k4(*args(mv, mc)))
    plain_ms = _median_ms(
        lambda: mg.merge_probe_gather_indexed_torch(*args(mv, mc)), 3)
    full = (ohk, bhk, bval, wrow_c, tidx, mv, mc, tile, wide)
    ms_full = _median_ms(lambda: k4(*full), 10)
    queued_full = _queued_ms(lambda: k4(*full))
    bound_full = listed_bound(tidx, wrow_c, mc)["bound_ms"]
    pads = int((sel >= n_wide).sum())  # wide tiles come first
    _print(f"phase kernels: merge_probe_gather_indexed equal to plain on "
           f"256 entries ({pads} narrow pads, 8 repeats) of the {n}-entry "
           f"tile list of the 16M x 256M Zipf two-class layout, tile {tile}, "
           f"wide window {wide}, {two.probe_chunks} chunks; kernel "
           f"{ms:.4f} ms ({queued:.4f} ms queued), plain {plain_ms:.4f} ms "
           f"(256 entries); kernel {ms_full:.4f} ms ({queued_full:.4f} ms "
           f"queued) on the whole wide pass")
    return dict(max_abs_err=err, ms=ms, ms_queued=queued, plain_ms=plain_ms,
                ms_full=ms_full, ms_full_queued=queued_full,
                bound_ms_full=bound_full, **bound,
                shape=f"256 entries of {n}, tile={tile} window={wide}")


def phase_padded_joins(dev, oracles) -> None:
    """Digests of the padded path against the oracle: the three padded
    plans of the TPU engine's hardware battery on its 262144 x 3.5M
    relation, 1M x 8M in sort mode, and 4M x 16M in the 4096-way radix
    mode (the phj_radix_4096way bench row's relation and plan)."""
    from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan

    draws, n_build, n_hits, n_miss = BATTERY
    rng = np.random.default_rng(3)
    ik = np.unique(rng.integers(1, 2**32, draws, dtype=np.uint32))[:n_build]
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    hits = ik[rng.integers(0, len(ik), n_hits)]
    miss = rng.integers(1, 2**32, n_miss, dtype=np.uint32)
    ok = np.concatenate([hits, miss]).astype(np.uint32)
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    data = (SimpleNamespace(keys=ik, vals=iv),
            SimpleNamespace(keys=ok, vals=ov))
    want = _oracle_digest(data)
    for label, plan, kernels in [
        ("padded pallas", JoinPlan(p_bits=10, slots=1024, tile=2048,
                                   pass_bits=(10,), probe_impl="pallas"),
         ["flat_to_rows", "probe_tiles"]),
        ("padded radix pass_bits=(5,5)", JoinPlan(
            p_bits=10, slots=1024, tile=2048, pass_bits=(5, 5),
            partition_impl="radix", probe_impl="pallas"),
         ["probe_tiles", "radix_partition"]),
        ("padded radix 4096-way pass_bits=(6,6)", _radix_4096_plan(),
         ["probe_tiles", "radix_partition"]),
    ]:
        _join_vs_oracle(f"{label} {len(ik)} x {len(ok)}", data, dev,
                        kernels, want, plan)
    data_1m, want = oracles["small"]
    _join_vs_oracle(f"sort mode {SMALL[0]} x {SMALL[1]}", data_1m, dev,
                    ["flat_to_rows", "probe_tiles"], want,
                    _sort_plan(*SMALL))
    data_r, want = oracles.pop("radix_4m")
    _join_vs_oracle(f"radix 4096-way {RADIX_4M[0]} x {RADIX_4M[1]}", data_r,
                    dev, ["probe_tiles", "radix_partition"], want,
                    _radix_4096_plan())


def _padded_stages(ik, iv, ok, ov, plan, ev=None) -> dict:
    """_phj_join_padded's steps one by one, in its order and through its
    own stage functions (tests/test_torch_smoke_stages.py holds the two
    equal); with `ev` (six CUDA events) each stage boundary is recorded.
    Returns the layout, the JoinResult's columns and the cardinality."""
    from hash_join_codes_knl_tpu_torch.engine import phj

    rec = (lambda i: ev[i].record()) if ev else (lambda i: None)
    phj._check_padded_plan(plan)
    rec(0)
    tk, tv, bcounts, bovf = phj._padded_build(ik, iv, plan)
    rec(1)
    pk, pv, tpid, tile, oovf = phj._padded_layout(ok, ov, plan)
    counts = bcounts
    if bovf is not None:
        counts = torch.full_like(bcounts, tk.shape[1])
        bcounts = torch.cat([bcounts, (bovf + oovf).view(1)])
    rec(2)
    mv, mc = phj._padded_probe(plan, pk, tk, tv, tpid, tile, counts)
    rec(3)
    keys = phj._unscramble(pk, plan.factor)
    rec(4)
    join_tuples = int(mc.sum(dtype=torch.int64))
    rec(5)
    return dict(tk=tk, tv=tv, pk=pk, tpid=tpid, probe_keys=keys,
                probe_vals=pv, match_vals=mv, match_cnts=mc,
                build_counts=bcounts, join_tuples=join_tuples)


RESULT_COLUMNS = ("probe_keys", "probe_vals", "match_vals", "match_cnts",
                  "build_counts")


def phase_padded(dev, cols, label, plan) -> None:
    """16M x 256M through join() in one padded mode: exact cardinality,
    no overflow, the kernels launched, median of 3 and peak memory."""
    from hash_join_codes_knl_tpu_torch.engine.phj import join
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    res, plan = join(*cols, plan)  # raises on any padded overflow
    d = _delta(before)
    got, want = int(res.join_tuples), expected_join_tuples(*HEADLINE)
    ovf = int(res.build_counts[-1]) if plan.partition_impl == "radix" else 0
    if got != want or ovf:
        raise AssertionError(f"{label}: join_tuples {got} != {want} or pass "
                             f"overflow {ovf}")
    need = ["probe_tiles"] + (["radix_partition"]
                              if plan.partition_impl == "radix" else [])
    for k in need:
        if d[k] == 0:
            raise AssertionError(f"{label}: {k} not launched: {d}")
    shape = res.probe_keys.shape[0]
    del res
    med, runs = _median_s(lambda: join(*cols, plan))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _print(f"phase padded: {label} 16M x 256M, join_tuples {got} exact, "
           f"pass overflow {ovf}; {shape} probe slots; launches {d}; "
           f"plan {plan}")
    _print(f"phase padded: {label} join median of 3 {med:.6f} s = "
           f"{HEADLINE[1] / med:.1f} probe-tuples/s (runs {runs}); peak "
           f"device memory {peak:.2f} GiB")


def padded_stage_breakdown(cols, label, plan) -> None:
    """Device time of each stage of one padded join at this plan, from
    CUDA events, with every result column held equal to join()'s.  Runs
    outside the counted window: its launches are not join()'s."""
    from hash_join_codes_knl_tpu_torch.engine.phj import join

    torch.cuda.empty_cache()
    res, _ = join(*cols, plan)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    st = _padded_stages(*cols, plan, ev)
    ev[5].synchronize()
    for f in RESULT_COLUMNS:
        if not torch.equal(st[f], getattr(res, f)):
            raise AssertionError(f"{label}: staged {f} differs from join()'s")
    del res, st
    names = ["partition_build", "partition_probe", "probe", "unscramble",
             "count"]
    stages = {n: round(ev[i].elapsed_time(ev[i + 1]), 4)
              for i, n in enumerate(names)}
    _print(f"phase padded: {label} stages equal join()'s result; stage ms "
           f"{stages}")


def _npj_digests(label, data, dev, want) -> None:
    """npj_join in both output orders and the chain walk, each held to
    `want`, join_oracle's digest (unique build keys: at most one
    match)."""
    from hash_join_codes_knl_tpu_torch.engine.npj import npj_join
    from hash_join_codes_knl_tpu_torch.engine.oracle import multiset_digest
    from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

    _, outer = data
    cols = _device_cols(data, dev)
    before = _launches()
    mv, mc, plan = npj_join(*cols)
    k_s, v_s, mv2, mc2, plan2 = npj_join(*cols, order="sorted")
    chain = dataclasses.replace(plan, probe_impl="chain", window=0)
    mv3, mc3, _ = npj_join(*cols, chain)
    d = _delta(before)
    k, v = outer.keys, outer.vals
    for name, keys, vals, mv_, mc_ in (
            ("input order", k, v, mv, mc),
            ("sorted order", to_numpy_u32(k_s), to_numpy_u32(v_s), mv2, mc2),
            ("chain walk", k, v, mv3, mc3)):
        if int(mc_.max()) > 1:
            raise AssertionError(f"npj {label} {name}: multi-match rows")
        m = mc_.cpu().numpy() == 1
        got = multiset_digest(keys[m], vals[m], to_numpy_u32(mv_)[m])
        if got != want:
            raise AssertionError(f"npj {label} {name}: digest {got} != "
                                 f"oracle {want}")
    if plan2 != plan:
        raise AssertionError(f"npj {label}: the orders re-planned apart: "
                             f"{plan} vs {plan2}")
    _print(f"phase npj: {label} digests equal the oracle's ({want[0]} rows) "
           f"in input order, sorted order and by the chain walk; launches "
           f"{d}; final plan {plan}")


def phase_npj(dev, label, cols, want):
    """npj_join at scale in both output orders: exact cardinality, K2
    launched, median of 3 at the final plan, peak memory."""
    from hash_join_codes_knl_tpu_torch.engine.npj import npj_join

    for order in ("input", "sorted"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = _launches()
        out = npj_join(*cols, order=order)
        d = _delta(before)
        got, plan = int(out[-2].sum(dtype=torch.int64)), out[-1]
        del out
        if got != want:
            raise AssertionError(f"npj {label} {order}: {got} != {want}")
        if d["merge_probe"] == 0:
            raise AssertionError(f"npj {label} {order}: K2 not launched {d}")
        med, runs = _median_s(lambda: npj_join(*cols, plan, order=order))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        _print(f"phase npj: {label} order={order} match count {got} exact; "
               f"launches {d}; final window {plan.window} tile {plan.tile} "
               f"(buckets {plan.buckets}); median of 3 {med:.6f} s = "
               f"{cols[2].shape[0] / med:.1f} probe-tuples/s (runs {runs}); "
               f"peak device memory {peak:.2f} GiB")
    return plan


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def _device_intervals(fn, want=()) -> list:
    """(kernel name, start us, end us) of every device interval of one
    fn() under torch.profiler, after one warm-up call; the trace must
    hold a kernel whose name contains each string of `want`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    # now and then torch.profiler comes back with no device events, or
    # without one of the call's kernels; the call is traced again then,
    # and a third such trace fails
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ks and all(any(w in name for name, _, _ in ks) for w in want):
            return ks
        _print(f"the profiler's trace missed device intervals ({len(ks)} "
               f"intervals, wanted {want}); tracing again")
    raise AssertionError(f"three traces missed device intervals {want}")


RADIX_SPLIT = (("histogram", "radix_histogram_kernel"),
               ("scatter", "radix_scatter_kernel"),
               ("prefill", "FillFunctor"))


def radix_trace(args, label) -> dict:
    """One radix_partition(*args) under torch.profiler, its device time
    split into the histogram kernel, the scatter kernel, the torch fills
    of the outputs and the remaining torch kernels (the destination scan
    of _destinations).  Runs outside the counted path runs."""
    from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp

    ks = _device_intervals(lambda: rp.radix_partition(*args),
                           [tag for _, tag in RADIX_SPLIT[:2]])
    split = dict.fromkeys([k for k, _ in RADIX_SPLIT] + ["destinations"], 0.0)
    calls = dict.fromkeys(split, 0)
    for name, a, b in ks:
        part = next((k for k, tag in RADIX_SPLIT if tag in name),
                    "destinations")
        split[part] += (b - a) / 1e3
        calls[part] += 1
    span = max(b for _, _, b in ks) - min(a for _, a, _ in ks)
    _print(f"phase kernels: radix_partition {label} traced: {len(ks)} device "
           f"intervals over {span / 1e3:.4f} ms; device ms "
           f"{ {k: round(v, 4) for k, v in split.items()} }; kernels "
           f"{calls}")
    return split


def npj_trace(cols, label, plan) -> dict:
    """One input-order npj_join at its final plan under torch.profiler:
    device ms by kernel name (summed intervals, largest first), the
    device's busy share between the call's first and last kernel, and
    K2's traced time.  Runs outside the counted path runs."""
    from hash_join_codes_knl_tpu_torch.engine.npj import npj_join

    torch.cuda.empty_cache()
    ks = _device_intervals(lambda: npj_join(*cols, plan),
                           ["merge_probe_dense_kernel"])
    by_name = {}
    for name, a, b in ks:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    k2_ms = sum(ms for name, ms in by_name.items()
                if "merge_probe_dense_kernel" in name)
    span = max(b for _, _, b in ks) - min(a for _, a, _ in ks)
    busy = _union_us([(a, b) for _, a, b in ks])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    _print(f"phase npj: {label} input order, traced: {len(ks)} device "
           f"intervals, busy {busy / 1e3:.4f} of {span / 1e3:.4f} ms between "
           f"the first and last kernel ({busy / span:.4f}); K2 {k2_ms:.4f} "
           f"ms")
    for name, ms in top[:8]:
        _print(f"phase npj: {label} traced kernel ms {ms:.4f}  {name[:100]}")
    return dict(ms_npj=k2_ms)


def npj_probe_inputs(cols, plan) -> tuple:
    """K2's arguments in npj_join's sorted probe at this plan, through
    the engine's own steps: (probe keys, table keys, table values, wrow,
    tile, window)."""
    from hash_join_codes_knl_tpu_torch.engine import npj
    from hash_join_codes_knl_tpu_torch.utils.hashing import bias

    ik, iv, ok, _ = cols
    tk, tv, _, _ = npj.npj_build(ik, iv, plan)
    k_s, _, wrow, _, window = npj.sorted_probe_layout(ok, plan, tk.shape[0],
                                                      plan.window)
    return bias(k_s), tk, tv, wrow, plan.tile, window


def _kernel_npj_probe(cols, label, plan) -> dict:
    """K2 on NPJ's table at its final plan: held against its plain
    version on 256 tiles spread over the sorted probe, then timed on all
    tiles with CUDA events, with its byte bound (the probes, the anchors,
    the union of the windows and both outputs).  Runs outside the counted
    path runs."""
    from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp

    ohk, tk, tv, wrow, tile, window = npj_probe_inputs(cols, plan)
    n_tiles = ohk.shape[0] // tile
    sel = torch.linspace(0, n_tiles - 1, 256, device=ohk.device).long()
    sub = (ohk.view(n_tiles, tile)[sel].reshape(-1).contiguous(), tk, tv,
           wrow[sel].contiguous(), tile, window)
    got, want = mp.merge_probe(*sub), mp.merge_probe_torch(*sub)
    _check_equal(f"merge_probe on NPJ's {label} table, 256 tiles", got,
                 want)
    err = _max_abs_err(got, want)
    plain_ms = _median_ms(lambda: mp.merge_probe_torch(*sub), 3)
    full = (ohk, tk, tv, wrow, tile, window)
    ms = _median_ms(lambda: mp.merge_probe(*full), 10)
    bound = _table_bound(ohk, wrow, window, tk.shape[0])
    _print(f"phase npj: {label} merge_probe equal to plain on 256 of "
           f"{n_tiles} tiles of the sorted probe (table {tk.shape[0]} slots, "
           f"tile {tile}, window {window}, "
           f"{mp.window_table_geometry(window, tile, n_tiles)}); kernel "
           f"{ms:.4f} ms on all tiles, bound {bound['bound_ms']:.4f} ms "
           f"({bound['bound_by']}); plain {plain_ms:.4f} ms (256 tiles)")
    return dict(max_abs_err_npj=err, ms_npj_events=ms,
                bound_ms_npj=bound["bound_ms"], plain_ms_npj=plain_ms)


KERNELS = [
    ("flat_to_rows", "hash_join_codes_knl_tpu_torch/csrc/chunk_layout.cu",
     "hash_join_codes_knl_tpu/ops/chunk_layout.py:61"),
    ("merge_probe", "hash_join_codes_knl_tpu_torch/csrc/merge_probe.cu",
     "hash_join_codes_knl_tpu/ops/merge_probe_pallas.py:374"),
    ("merge_probe_gather",
     "hash_join_codes_knl_tpu_torch/csrc/merge_probe_gather.cu",
     "hash_join_codes_knl_tpu/ops/merge_probe_gather.py:296"),
    ("merge_probe_gather_indexed",
     "hash_join_codes_knl_tpu_torch/csrc/merge_probe_gather.cu",
     "hash_join_codes_knl_tpu/ops/merge_probe_pallas.py:241"),
    ("probe_tiles", "hash_join_codes_knl_tpu_torch/csrc/probe_tiles.cu",
     "hash_join_codes_knl_tpu/ops/probe_pallas.py:120"),
    ("radix_partition",
     "hash_join_codes_knl_tpu_torch/csrc/radix_partition.cu",
     "hash_join_codes_knl_tpu/ops/radix_partition_pallas.py:156"),
]
# the kernels each path must launch
MERGE_KERNELS = ["flat_to_rows", "merge_probe", "merge_probe_gather",
                 "merge_probe_gather_indexed"]
PADDED_KERNELS = ["flat_to_rows", "probe_tiles", "radix_partition"]
NPJ_KERNELS = ["merge_probe"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _print(smi)

    from hash_join_codes_knl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    _print(f"phase build: kernels ready in {time.perf_counter() - t0:.3f} s "
           f"(nvcc {_build.build_info['seconds']:.3f} s)")
    for kernel, report in _ptxas_report(_build.build_info["ptxas"]):
        _print(f"phase build: ptxas {kernel}: {report}")

    from hash_join_codes_knl_tpu_torch.engine.config import plan_join

    data_h, gen_s = _generate(*HEADLINE, seed=42, mode="uniform")
    cols_h = _device_cols(data_h, dev)
    del data_h
    data_1m, _ = _generate(*SMALL, seed=41, mode="uniform")
    _stamp("the build and the generation of 16M x 256M and 1M x 8M")
    stats = phase_kernels(dev, _device_cols(data_1m, dev), cols_h)
    _stamp("the kernel checks")
    torch.cuda.empty_cache()
    _stage_breakdown(cols_h, plan_join(*HEADLINE))  # warm-up
    _print(f"phase kernels: headline stage ms "
           f"{_stage_breakdown(cols_h, plan_join(*HEADLINE))}")
    torch.cuda.empty_cache()

    # the paths' runs: every launch count starts at 0 just before a path,
    # is read just after it, and only the path's entry points (join(),
    # npj_join()) add to it there (the two-class plan's set-up puts its
    # counts back); the kernel checks, stage breakdowns and the trace that
    # need a path's plan run after the read
    _set_launches()
    # no timed phase runs beside the host threads: those before this
    # line are over, and the next one starts when the threads are done
    oracles = _start_oracles(data_1m)
    phase_joins(dev, oracles)
    concurrent.futures.wait([digest for _, digest in oracles.values()])
    _stamp("the merge path's digests")
    phase_headline(dev, cols_h, gen_s)
    _stamp("the merge headline")
    torch.cuda.empty_cache()
    cols_z, plan_z, want_z = phase_zipf_headline(dev)
    _stamp("the Zipf headline")
    two, n_wide = phase_two_class(dev, cols_z, plan_z, want_z)
    _stamp("the two-class join")
    merge = _launches()
    _print(f"launches, merge path: {merge}")
    torch.cuda.empty_cache()
    k4 = _kernel_indexed(dev, cols_z, two, n_wide)
    head = stats.pop("k4_headline")
    k4["max_abs_err"] = max(k4["max_abs_err"],
                            head.pop("max_abs_err_headline"))
    stats["merge_probe_gather_indexed"] = {**k4, **head}
    _stamp("K4's check")
    del cols_z
    torch.cuda.empty_cache()

    _set_launches()
    phase_padded_joins(dev, oracles)
    _stamp("the padded path's digests")
    phase_padded(dev, cols_h, "sort mode", _sort_plan(*HEADLINE))
    phase_padded(dev, cols_h, "radix 4096-way", _radix_4096_plan())
    _stamp("the padded 16M x 256M joins")
    padded = _launches()
    _print(f"launches, padded path: {padded}")
    padded_stage_breakdown(cols_h, "sort mode", _sort_plan(*HEADLINE))
    padded_stage_breakdown(cols_h, "radix 4096-way", _radix_4096_plan())
    _stamp("the padded stage breakdowns")
    torch.cuda.empty_cache()

    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples

    _set_launches()
    _npj_digests(f"{SMALL[0]} x {SMALL[1]}", data_1m, dev,
                 oracles["small"][1].result())
    _stamp("NPJ's digests")
    del data_1m
    data_n, _ = _generate(*NPJ_4M, seed=42, mode="uniform")
    cols_n = _device_cols(data_n, dev)
    del data_n
    phase_npj(dev, f"{NPJ_4M[0]} x {NPJ_4M[1]}", cols_n,
              expected_join_tuples(*NPJ_4M))
    del cols_n
    plan_n = phase_npj(dev, f"{HEADLINE[0]} x {HEADLINE[1]}", cols_h,
                       expected_join_tuples(*HEADLINE))
    _stamp("the NPJ joins")
    npj = _launches()
    _print(f"launches, npj path: {npj}")
    stats["merge_probe"].update(npj_trace(
        cols_h, f"{HEADLINE[0]} x {HEADLINE[1]}", plan_n))
    _stamp("the NPJ trace")
    torch.cuda.empty_cache()
    stats["merge_probe"].update(_kernel_npj_probe(
        cols_h, f"{HEADLINE[0]} x {HEADLINE[1]}", plan_n))
    stats["merge_probe"]["max_abs_err"] = max(
        stats["merge_probe"]["max_abs_err"],
        stats["merge_probe"].pop("max_abs_err_npj"))
    _stamp("K2's check on NPJ's table")
    del cols_h
    for path, names, got in (("merge", MERGE_KERNELS, merge),
                             ("padded", PADDED_KERNELS, padded),
                             ("npj", NPJ_KERNELS, npj)):
        for name in names:
            if got[name] == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{path} path")

    # no single PyTorch call computes any of these kernels' functions
    # (PERF.md says why, kernel by kernel), so library_ms is null
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=merge[name] + padded[name] + npj[name],
                    library_ms=None, **stats[name])
               for name, src, rep in KERNELS]
    _print(json.dumps({"kernels": kernels}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
