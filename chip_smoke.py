"""Smoke run of the PyTorch/CUDA port (hash_join_codes_knl_tpu_torch) on
one NVIDIA GPU: build the kernels, hold each against its plain PyTorch
version (the indexed wide-window probe K4 also on a headline-sized tile
list, against the wide-window probe K3 over all tiles; the uint32 key
unscramble on the headline probe side's full padded column), then drive the
three paths of the port.  The merge path of
join(): digests against the numpy oracle, the 16M x 256M headline join,
its Zipf z=1.0 twin and the two-class window geometry on the same
columns.  The padded path (sort-mode and radix-partitioned PHJ): digests
against the oracle, then 16M x 256M in sort mode and in the 4096-way
radix mode.  The NPJ path (npj_join): digests against the oracle, then
4M x 16M and 16M x 256M in both output orders, then the dense window
probe alone on the 16M x 256M table.  The CLI path
(hash_join_codes_knl_tpu_torch.cli, as a user runs it): write, then phj
and npj from those files at 1M x 8M, then the 16M x 256M headline phj
with --timelog --check --aggregate (its phase seconds, roofline shares
and aggregate group count).  Then the hash aggregate's three bench row
shapes on the headline's probe columns.  The merge path's M:N join is
also expanded (materialize_expanded) and aggregated, against the numpy
oracle.  The plan-time chunk-count tuner runs first, with a fresh cache
file that every later plan reads.  Last, the out-of-core path:
stream_join at 16M x 1000M (16 chunks of 64M probe rows from host RAM,
exact, with its copy and compute overlap), its resume after a corrupted
chunk (4M x 64M, digests against the oracle), grace_join at 256M x 1000M
(64 partitions, exact) and its rerun from the partition files and the
journal, both out-of-core CLI modes, and the multi-column joins (1M x 8M
M:N, four modes, u64 and two-column keys) against a numpy oracle.  Then
the distributed path (parallel/): a world of one NCCL rank at 16M x 256M
(cpra_join, its skew step on the Zipf twin, the CLI's staged cpra, and
npj_join_dist at 4M x 16M), then four gloo thread ranks sharing the card
(cpra_join at 16M x 256M; at 4M x 64M the radix pack, tier routing,
skew, the pipelined and two-level steps and a padded radix local plan;
npj_join_dist; grace_join_dist at 16M x 64M and its resume), each
against join_oracle's digest, and the kernels it launched held against
their plain versions on rank 0's inputs there.  Then the fuzz path: every
draw of the randomized differential campaigns (tests/torch_fuzz_cases.py,
the draws of tests/test_fuzz.py) on the card against the same draw on
the CPU and the oracle, and four draws at 16M x 256M with a random tile
and chunk count (the uniform relation, a two-class plan on it, a Zipf
0.75 relation, a heavy-hitter probe side) against join_oracle's digest;
all seven kernels must launch there, and after its counts are read K1,
the probe each draw's plan dispatches and K4 (on the two-class draw's
own tile list) are held against their plain versions on those draws.
Last, the surface path,
as a user runs it: bench_torch.py at 16M x 256M (exact), the config
matrix (scripts/torch_bench_configs.py) at full size for the rows no
other phase times and at --small for every row, the stream, Grace and
scaling benches at 4M x 64M, the five examples (each a process, whose
kernel launch counts come back through a file written at its exit),
then __graft_entry_torch__'s entry() against the same step on the CPU
and dryrun_multichip(4) on four thread ranks.

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
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from hash_join_codes_knl_tpu_torch.utils.bench import grace_data, picks
from hash_join_codes_knl_tpu_torch.utils.trace import (
    device_intervals as _device_intervals,
)
from hash_join_codes_knl_tpu_torch.utils.trace import union_us as _union_us
from hash_join_codes_knl_tpu_torch.utils.roofline import (
    H100_SXM_BYTES_PER_S,
)

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE = (16_000_000, 256_000_000)  # bench.py's shape
HEADLINE_4M = (4_000_000, 64_000_000)  # the digest check's shape
RADIX_4M = (4_000_000, 16_000_000)  # the phj_radix_4096way bench row
SMALL = (1_000_000, 8_000_000)  # the dense probe's and sort mode's shape
# the TPU engine's hardware battery relation (scripts/tpu_smoke.py):
# build keys unique among 400K draws, probe hits drawn from them, misses
BATTERY = (400_000, 262_144, 3_000_000, 500_000)
NPJ_4M = (4_000_000, 16_000_000)  # the npj_uniform bench row's shape

# one H100 SXM at its 700 W limit: device memory rate (the roofline's
# one definition), and the 32-bit integer rate (132 SMs x 64 INT32
# lanes x 1.98 GHz; the float32 rate of 67 TFLOP/s counts 128 lanes and
# two operations per FMA)
HBM_BYTES_PER_S = H100_SXM_BYTES_PER_S
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
    torch.cuda.empty_cache()
    out["mul_u32"] = _kernel_scramble(cols_h, plan_h, cap_h)
    return out


def _kernel_scramble(cols_h, plan, cap: int) -> dict:
    """The key unscramble where every PHJ join runs it: K1's biased
    scrambled probe column of the headline plan (cap slots, pads
    included) back to the keys, against the plain int64 version; also a
    misaligned slice (the kernel's 4-byte path) and the scramble with the
    bias after it (CPRA's radix pack, the check).  Beside the kernel: the
    same product as torch's int32 multiply after an int32 xor, two calls
    whose wrap-around on the card is not promised by C++."""
    from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
    from hash_join_codes_knl_tpu_torch.ops import scramble as sc
    from hash_join_codes_knl_tpu_torch.utils.hashing import (
        BIAS,
        mod_inverse_u32,
    )

    hk = cl.flat_to_rows(cols_h[2], cols_h[3], cap, plan.probe_chunks,
                         plan.factor)[0].view(-1)
    inv = mod_inverse_u32(plan.factor)
    args = (hk, inv, BIAS)
    got, want = sc.mul_u32(*args), sc.mul_u32_torch(*args)
    _check_equal(f"mul_u32 unscramble, {cap} slots", [got], [want])
    err = _max_abs_err([got], [want])
    n = HEADLINE[1]
    if not torch.equal(got[:n], cols_h[2]) or bool(got[n:].any()):
        raise AssertionError("mul_u32: the unscramble did not give back "
                             "the probe keys and zero pads")
    del want
    for label, a in (("a misaligned slice", (hk[1:], inv, BIAS)),
                     ("the biased scramble", (cols_h[2], plan.factor, 0,
                                              BIAS))):
        g, w = sc.mul_u32(*a), sc.mul_u32_torch(*a)
        _check_equal(f"mul_u32, {label}", [g], [w])
        err = max(err, _max_abs_err([g], [w]))
    del g, w
    ms = _median_ms(lambda: sc.mul_u32(*args), 20)
    plain_ms = _median_ms(lambda: sc.mul_u32_torch(*args), 5)
    inv32 = inv - 2**32 if inv >= 2**31 else inv
    int32_ms = _median_ms(lambda: (hk ^ BIAS) * inv32, 20)
    int32_equal = torch.equal((hk ^ BIAS) * inv32, got)
    bound = _bound(8 * cap)  # each slot read once and written once
    _print(f"phase kernels: mul_u32 equal to plain on the headline probe "
           f"side's unscramble ({cap} slots, C={plan.probe_chunks}; the "
           f"keys and zero pads come back), a misaligned slice and the "
           f"biased scramble of {n} keys; kernel {ms:.4f} ms, plain "
           f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
           f"({bound['bound_ms'] / ms:.0%}); torch int32 xor + multiply "
           f"{int32_ms:.4f} ms (equal: {int32_equal})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                int32_xor_mul_ms=int32_ms, int32_xor_mul_equal=int32_equal,
                **bound, shape=f"n={cap} unscramble")


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


# every kernel wrapper by name: (module of ops/, function); each counts
# its launches
WRAPPERS = {"flat_to_rows": ("chunk_layout", "flat_to_rows"),
            "merge_probe": ("merge_probe", "merge_probe"),
            "merge_probe_gather": ("merge_probe_gather",
                                   "merge_probe_gather"),
            "merge_probe_gather_indexed": ("merge_probe_gather",
                                           "merge_probe_gather_indexed"),
            "probe_tiles": ("probe", "probe_tiles"),
            "radix_partition": ("radix_partition", "radix_partition"),
            "mul_u32": ("scramble", "mul_u32")}


def _wrappers() -> dict:
    """Every kernel wrapper by name."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"hash_join_codes_knl_tpu_torch.ops.{mod}"), fn)
        for name, (mod, fn) in WRAPPERS.items()}


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
    _join_vs_oracle("uniform 1M x 8M", data_1m, dev,
                    ["merge_probe", "mul_u32"], want)
    data_4m, want = oracles.pop("uniform_4m")
    _join_vs_oracle("uniform 4M x 64M", data_4m, dev,
                    ["flat_to_rows", "merge_probe_gather", "mul_u32"], want)
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
    _mn_expansion(res, ik, iv, ok, ov)


def _mn_expansion(res, ik, iv, ok, ov) -> None:
    """The M:N result expanded into rows (materialize_expanded, in one
    block and in blocks of 2M rows) against join_oracle's digest, and
    aggregated (aggregate_join_result_expanded) against the group count
    and sum checksum of a numpy group-by over the oracle's rows."""
    from hash_join_codes_knl_tpu_torch.engine.oracle import (
        join_oracle,
        multiset_digest,
    )
    from hash_join_codes_knl_tpu_torch.engine.phj import materialize_expanded
    from hash_join_codes_knl_tpu_torch.ops.aggregate import (
        aggregate_join_result_expanded,
    )
    from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

    ek, ev, et = join_oracle(ik, iv, ok, ov)
    want = multiset_digest(ek, ev, et)
    for block_rows in (0, 2_000_000):
        t0 = time.perf_counter()
        got = multiset_digest(*materialize_expanded(res, ik, iv,
                                                    block_rows=block_rows))
        if got != want:
            raise AssertionError(f"materialize_expanded block_rows="
                                 f"{block_rows}: digest {got} != oracle "
                                 f"{want}")
        _print(f"phase join: M:N materialize_expanded block_rows="
               f"{block_rows}: digest equals the oracle's ({got[0]} rows; "
               f"{time.perf_counter() - t0:.3f} s with the digest)")
    order = np.argsort(ek, kind="stable")
    ek_s = ek[order]
    starts = np.flatnonzero(np.r_[True, ek_s[1:] != ek_s[:-1]])
    sums = np.add.reduceat(et[order].astype(np.uint64), starts) & 0xFFFFFFFF
    want_agg = (len(starts), int(sums.sum(dtype=np.uint64)))
    ng, _, gsum, _ = aggregate_join_result_expanded(res, ik, iv)
    g = int(ng)
    got_agg = (g, int(to_numpy_u32(gsum[:g]).astype(np.uint64).sum()))
    if got_agg != want_agg:
        raise AssertionError(f"M:N aggregate (groups, sum checksum) "
                             f"{got_agg} != numpy {want_agg}")
    _print(f"phase join: M:N aggregate_join_result_expanded: {g} groups, "
           f"sum checksum {got_agg[1]}, equal to the numpy group-by")


def phase_headline(dev, cols, gen_s) -> float:
    from hash_join_codes_knl_tpu_torch.engine.phj import join
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples

    torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    res, plan = join(*cols)
    d = _delta(before)
    got, want = int(res.join_tuples), expected_join_tuples(*HEADLINE)
    if got != want:
        raise AssertionError(f"headline: join_tuples {got} != {want}")
    if 0 in (d["flat_to_rows"], d["merge_probe_gather"], d["mul_u32"]):
        raise AssertionError(f"headline: K1/K3/mul_u32 not launched: {d}")
    del res
    med, runs = _median_s(lambda: join(*cols, plan))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    _print(f"phase headline: 16M x 256M uniform, generation {gen_s:.3f} s "
           f"(host); join_tuples {got} exact; launches {d}; plan {plan}")
    _print(f"phase headline: join median of 3 {med:.6f} s = "
           f"{HEADLINE[1] / med:.1f} probe-tuples/s (runs {runs}); peak "
           f"device memory {peak:.2f} GiB")
    return med


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
    return data, cols, plan, want


def _tile_spans(cols, plan):
    """The per-tile spans of these columns at the single-class plan that
    join() settled on (the anchors _merge_windows uses): (span at the
    plan's window, a function of a window giving the spans at it, the
    window).  Its sorts launch K1, which is set-up, not the path's: the
    launch counts are put back."""
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

    def at(w):
        return phj._anchored(wrow_raw, hi_row, w, rows)[1]

    return at(window), at, window


def _span_quantiles(span, qs) -> list:
    q = torch.quantile(span.double(), torch.tensor(
        qs, dtype=torch.float64, device=span.device))
    return [int(x) for x in q.tolist()]


def _two_class_from(plan, at, window, narrow):
    """The two-class plan at this narrow window: the wide window the
    single-class one, wide_cap the count of tiles past the narrow window
    rounded up to a multiple of 128.  Returns (plan, wide tile count)."""
    n_wide = int((at(narrow) > narrow).sum())
    two = dataclasses.replace(plan, window=narrow, window_wide=window,
                              wide_cap=max(128, -(-n_wide // 128) * 128))
    return two, n_wide


def _two_class_plan(cols, plan):
    """The two-class plan for these columns, from the single-class plan
    that join() settled on: the narrow window from the p90 tile span and
    the rest as _two_class_from sets it.  Returns (plan, span quantiles
    p50/p90/p99/max, wide tile count)."""
    from hash_join_codes_knl_tpu_torch.engine import phj

    span, at, window = _tile_spans(cols, plan)
    qs = _span_quantiles(span, [0.5, 0.9, 0.99, 1.0])
    narrow = phj.window_from_span(qs[1])
    if narrow >= window:
        raise AssertionError(f"two-class: the p90 span's window {narrow} is "
                             f"not below the single-class window {window}")
    two, n_wide = _two_class_from(plan, at, window, narrow)
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


# the engine's merge probes (engine/phj.py _PROBES) by their wrappers'
# names
_PROBE_NAMES = {"merge_pallas": "merge_probe",
                "merge_gather": "merge_probe_gather"}


def _two_class_layout(cols, two):
    """A two-class plan's layout of these columns, through the engine's
    own stages, and its narrow pass's outputs (the probe the plan
    dispatches at the narrow window): a namespace of ohk, bhk, bval,
    wrow, tidx, wrow_c (the wide pass's tile list and anchors), mv0, mc0,
    tile, window (the narrow one), impl (the narrow probe's name)."""
    from hash_join_codes_knl_tpu_torch.engine import phj

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
    impl = phj._merge_impl(two, window)
    mv0, mc0 = phj._PROBES[impl](ohk, bhk, bval, wrow, tile, window)
    return SimpleNamespace(ohk=ohk, bhk=bhk, bval=bval, wrow=wrow,
                           tidx=tidx, wrow_c=wrow_c, mv0=mv0, mc0=mc0,
                           tile=tile, window=window, impl=_PROBE_NAMES[impl])


def _k4_vs_plain(dev, lay, two, label):
    """K4 against its plain version on 256 entries spread over the
    layout's tile list (wide tiles, narrow pads, and 8 repeated entries),
    written onto the narrow pass's outputs, its blocks over the plan's
    chunks as the engine runs it.  Returns (max abs err, the entries'
    positions in the list, their tile ids and anchors, K4's outputs)."""
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    n = lay.tidx.shape[0]
    sel = torch.linspace(0, n - 1, 248, device=dev).long()
    sel = torch.cat([sel, sel[:8]])
    ti, wc = lay.tidx[sel].contiguous(), lay.wrow_c[sel].contiguous()

    def args():  # onto fresh copies of the narrow pass's outputs
        return (lay.ohk, lay.bhk, lay.bval, wc, ti, lay.mv0.clone(),
                lay.mc0.clone(), lay.tile, two.window_wide)

    got = mg.merge_probe_gather_indexed(*args(), two.probe_chunks)
    want = mg.merge_probe_gather_indexed_torch(*args())
    _check_equal(f"merge_probe_gather_indexed, 256 entries of {label}", got,
                 want)
    return _max_abs_err(got, want), sel, ti, wc, got


def _kernel_indexed(dev, cols, two, n_wide) -> dict:
    """K4 against its plain version on 256 entries spread over the
    two-class layout's tile list (_k4_vs_plain); then K4's time on the
    whole wide pass.  Runs outside the counted path runs."""
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    lay = _two_class_layout(cols, two)
    ohk, bhk, bval, tile = lay.ohk, lay.bhk, lay.bval, lay.tile
    wrow_c, tidx, mv0, mc0 = lay.wrow_c, lay.tidx, lay.mv0, lay.mc0
    wide, n = two.window_wide, lay.tidx.shape[0]
    err, sel, ti, wc, got = _k4_vs_plain(
        dev, lay, two, "the 16M x 256M Zipf two-class layout")

    def args(mv, mc):
        return (ohk, bhk, bval, wc, ti, mv, mc, tile, wide)

    def k4(*a):  # the blocks over the plan's chunks, as the engine runs it
        return mg.merge_probe_gather_indexed(*a, two.probe_chunks)

    def listed_bound(ids, anchors, mc):
        ids = ids.long()
        return _search_bound(ohk.view(-1, tile)[ids], anchors, wide,
                             bhk.shape[0], mc.view(-1, tile)[ids], 8)

    bound = listed_bound(ti, wc, got[1])
    del got
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
    from hash_join_codes_knl_tpu_torch.ops.scramble import unscramble

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
    keys = unscramble(pk, plan.factor)
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


def _cli(argv) -> tuple:
    """cli.main(argv) as a user runs it: (exit code, the JSON of its last
    standard-output line or None, its standard error)."""
    from hash_join_codes_knl_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    js = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    if rc != 0 or js is None:
        raise AssertionError(f"cli {argv}: exit {rc}, stdout "
                             f"{out.getvalue()[-2000:]!r}, stderr "
                             f"{err.getvalue()[-2000:]!r}")
    return rc, js, err.getvalue()


def phase_cli_files(tmp: str) -> None:
    """write, then phj and npj from the files, at 1M x 8M, each through
    cli.main; cardinality against the searchsorted count of the files'
    keys (outer > inner: the CLI's analytic gate does not apply)."""
    from hash_join_codes_knl_tpu_torch.relation import load_relation

    ni, no = SMALL
    sizes = [str(no), str(ni)]
    t0 = time.perf_counter()
    _, meta, _ = _cli(["write", "1", *sizes, "--dir", tmp, "--seed", "41"])
    write_s = time.perf_counter() - t0
    inner = load_relation("inner", ni, tmp)
    outer = load_relation("outer", no, tmp)
    want = _oracle_count(inner.keys, outer.keys)
    del inner, outer
    runs = []
    for argv in (["phj"], ["npj"], ["npj", "--sorted-order"]):
        _, out, _ = _cli([argv[0], "1", *sizes, "--dir", tmp, "--json",
                          *argv[1:]])
        if out["join_tuples"] != want:
            raise AssertionError(f"cli {argv} from files: join_tuples "
                                 f"{out['join_tuples']} != {want}")
        runs.append(f"{' '.join(argv)} {out['tuples_per_s']:.1f} tuples/s "
                    f"(phases {_phase_s(out)})")
    _print(f"phase cli: write {ni} x {no} ({write_s:.3f} s, mode "
           f"{meta['mode']}); from the files, join_tuples {want} equal the "
           f"searchsorted count in {'; '.join(runs)}")


def _phase_s(out: dict) -> dict:
    """A CLI report's phase seconds, by phase."""
    return {k[:-2]: v for k, v in out.items()
            if k.endswith("_s") and k not in ("total_s", "tuples_per_s")}


def phase_cli_headline(tmp: str, cols) -> dict:
    """The headline through the CLI: phj 1 256000000 16000000 --json
    --timelog --check --aggregate (generated in memory, as the CLI does:
    the same relations as the headline's columns).  Exact cardinality,
    the staged phases and the roofline, the checks' stats, and the
    aggregate's group count held equal to the distinct matched probe
    keys of the headline columns (torch.unique on the card)."""
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples

    ni, no = HEADLINE
    t0 = time.perf_counter()
    _, out, err = _cli(["phj", "1", str(no), str(ni), "--json", "--timelog",
                        "--check", "--aggregate", "--dir", tmp])
    wall = time.perf_counter() - t0
    want = expected_join_tuples(ni, no)
    if out["join_tuples"] != want:
        raise AssertionError(f"cli headline: join_tuples "
                             f"{out['join_tuples']} != {want}")
    lines = {k: line for line in err.splitlines()
             for k in ("CHECK OK", "AGGREGATE") if line.startswith(k)}
    if set(lines) != {"CHECK OK", "AGGREGATE"}:
        raise AssertionError(f"cli headline: no check or aggregate line in "
                             f"{err[-2000:]!r}")
    groups = int(re.search(r"AGGREGATE: (\d+) groups",
                           lines["AGGREGATE"]).group(1))
    ik, _, ok, _ = cols
    u = torch.unique(ok)
    distinct = int(torch.isin(u[u != 0], ik).sum())
    if groups != distinct:
        raise AssertionError(f"cli headline: {groups} groups != {distinct} "
                             "distinct matched probe keys")
    phases = _phase_s(out)
    stages = ("partition_build", "partition_probe", "windows", "probe")
    roof = {p: (out[f"{p}_gbps"], out[f"{p}_pct_roofline"]) for p in stages
            if f"{p}_gbps" in out}
    _print(f"phase cli: phj {no} x {ni} --timelog --check --aggregate: "
           f"join_tuples {out['join_tuples']} exact; {lines['CHECK OK']}; "
           f"{lines['AGGREGATE']} = the distinct matched probe keys "
           f"(torch.unique); tuples_per_s {out['tuples_per_s']} "
           f"(total {out['total_s']} s of phases; {wall:.3f} s with "
           "generation)")
    _print(f"phase cli: headline phase s {phases}; staged join "
           f"{sum(phases[p] for p in stages):.6f} s")
    _print(f"phase cli: roofline (GB/s, % of {out['hbm_peak_gbps']} GB/s, "
           f"{out['hbm_peak_source']}) {roof}; pipeline "
           f"{out['pipeline_pct_roofline']}%")
    return out


def phase_aggregates(cols) -> None:
    """The hash aggregate at the bench's three row shapes on the
    headline's probe columns (256M rows): single-level over its 16M
    groups, chunked (64 chunks, partial_cap 2^23) over the keys folded
    to 64K groups, and single-level over those; CUDA-event medians of 3.
    Chunked and single-level are held equal on the groups."""
    from hash_join_codes_knl_tpu_torch.ops.aggregate import (
        hash_aggregate,
        hash_aggregate_chunked,
    )

    _, _, ok, ov = cols
    ng = int(hash_aggregate(ok, ov)[0])
    if ng != HEADLINE[0]:
        raise AssertionError(f"aggregate: {ng} groups != {HEADLINE[0]}")
    ms_16m = _median_ms(lambda: hash_aggregate(ok, ov), 3)
    folded = (ok & 0xFFFF) + 1
    n1, k1, s1, c1, ovf = hash_aggregate_chunked(folded, ov, chunks=64,
                                                 partial_cap=1 << 23)
    g = int(n1)
    n0, k0, s0, c0 = hash_aggregate(folded, ov)
    if int(ovf) != 0 or int(n0) != g or not all(
            torch.equal(a[:g], b[:g]) for a, b in ((k1, k0), (s1, s0),
                                                   (c1, c0))):
        raise AssertionError(f"aggregate: chunked ({g} groups, overflow "
                             f"{int(ovf)}) differs from single-level "
                             f"({int(n0)} groups)")
    del n1, k1, s1, c1, n0, k0, s0, c0
    ms_chunked = _median_ms(lambda: hash_aggregate_chunked(
        folded, ov, chunks=64, partial_cap=1 << 23), 3)
    ms_64k = _median_ms(lambda: hash_aggregate(folded, ov), 3)
    n = ok.shape[0]
    _print(f"phase aggregate: {n} rows, CUDA-event medians of 3: "
           f"hash_aggregate {ng} groups {ms_16m:.3f} ms; "
           f"hash_aggregate_chunked (64 chunks, partial_cap 2^23) {g} "
           f"groups {ms_chunked:.3f} ms; hash_aggregate {g} groups "
           f"{ms_64k:.3f} ms; chunked equals single-level on the {g} "
           "groups")


# the out-of-core shapes: the stream_join_16Mx1000M and
# grace_join_256Mx1000M bench rows (scripts/bench_stream.py,
# scripts/bench_grace.py: build keys distinct, the probe side uniform
# picks from them), the resume check's and the CLI's 4M x 64M, and the
# multi-column joins' 1M x 8M
STREAM = (16_000_000, 1_000_000_000, 64_000_000)  # build, probe, chunk
GRACE = (256_000_000, 1_000_000_000, 6, 32_000_000)  # + f_bits, chunk
RESUME = (4_000_000, 64_000_000, 16_000_000)
COLUMNS = (1_000_000, 8_000_000)


def phase_tuner(cols) -> None:
    """The plan-time tuner with the fresh cache file main() names
    (HJK_TUNE_CACHE): the headline plan's candidates (plan_join, so the
    merge path's headline runs under the tuned plan) and the 64M-row
    stream chunk's, each printed from the cache with its candidate times;
    a second call hits the cache (no sort timed).  Then the headline join
    at the untuned default (64 chunks) and at the pick, in turns (64,
    pick, pick, 64), each a median of 3."""
    from hash_join_codes_knl_tpu_torch.engine import tune
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.phj import join

    timed = []
    real = tune._time_sort

    def counted(*a):
        timed.append(a[1])
        return real(*a)

    tune._time_sort = counted
    try:
        for label, n, call in (
                (f"plan_join {HEADLINE[0]} x {HEADLINE[1]}", HEADLINE[1],
                 lambda: plan_join(*HEADLINE).probe_chunks),
                (f"tuned_probe_chunks({STREAM[2]})", STREAM[2],
                 lambda: tune.tuned_probe_chunks(STREAM[2]))):
            t0 = time.perf_counter()
            pick = call()
            first_s = time.perf_counter() - t0
            n_timed = len(timed)
            t0 = time.perf_counter()
            again = call()
            again_s = time.perf_counter() - t0
            if again != pick or len(timed) != n_timed or not n_timed:
                raise AssertionError(f"tuner {label}: picked {pick} then "
                                     f"{again}; sorts timed {timed}")
            with open(os.environ["HJK_TUNE_CACHE"]) as f:
                entries = {k: v for k, v in json.load(f).items()
                           if k.startswith(f"{n}|")}
            _print(f"phase tuner: {label}: probe_chunks {pick} in "
                   f"{first_s:.3f} s ({n_timed} sorts timed in all so far); "
                   f"second call {again_s:.6f} s, a cache hit; cache "
                   f"{entries}")
    finally:
        tune._time_sort = real
    plan = plan_join(STREAM[0], STREAM[2])
    _print(f"phase tuner: the stream chunk's plan {plan} (c_win below every "
           f"candidate: untimed)")
    tuned = plan_join(*HEADLINE)
    plans = {64: plan_join(*HEADLINE, probe_chunks=64),
             tuned.probe_chunks: tuned}
    for C, plan in plans.items():  # checked warm-ups
        res, final = join(*cols, plan)
        if int(res.join_tuples) != HEADLINE[1] or final != plan:
            raise AssertionError(f"tuner: headline at C={C} gave "
                                 f"{int(res.join_tuples)} tuples, plan "
                                 f"{final}")
        del res
    runs = [(C, _median_s(lambda: join(*cols, plans[C])[0])[0])
            for C in (64, tuned.probe_chunks, tuned.probe_chunks, 64)]
    _print(f"phase tuner: headline join medians of 3 at (probe_chunks, s), "
           f"in turns: {runs}")


@contextlib.contextmanager
def _host_seconds(module, names):
    """Wrap module.<name> for each of `names` while the block runs;
    yields {name: host seconds spent in its calls, summed}."""
    spent = dict.fromkeys(names, 0.0)
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[n](*a, **kw)
            finally:
                spent[n] += time.perf_counter() - t0
        return timed

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield spent
    finally:
        for n in names:
            setattr(module, n, real[n])


def _transfer_line(res) -> str:
    t = res.transfer
    return (f"H2D {t['h2d_bytes'] / 1e9:.3f} GB in {t['h2d_ms']:.3f} ms of "
            f"copy-stream time ({t['h2d_bytes'] / t['h2d_ms'] / 1e6:.2f} "
            f"GB/s); {t['hidden_ms']:.3f} ms of it overlapped the chunks' "
            f"compute ({100 * t['hidden_ms'] / t['h2d_ms']:.1f}%), compute "
            f"{t['compute_ms']:.3f} ms")


def _outofcore_stream(dev) -> None:
    """stream_join at the stream_join_16Mx1000M row's shape, twice: 16
    chunks of 64M probe rows from host RAM.  Every probe row picks one of
    16M distinct build keys (np.unique), so the exact count is the probe
    row count, and each chunk's its row count."""
    from hash_join_codes_knl_tpu_torch.engine import stream
    from hash_join_codes_knl_tpu_torch.engine.stream import stream_join

    ni, no, chunk = STREAM
    (inner, _), gen_s = _generate(ni, ni, seed=42, mode="ref")
    if np.unique(inner.keys).size != ni:
        raise AssertionError("stream: build keys not distinct")
    t0 = time.perf_counter()
    ok, ov = picks(dev, inner.keys, no, 7, 0x85EBCA77)
    pick_s = time.perf_counter() - t0
    for run in (1, 2):
        before = _launches()
        torch.cuda.synchronize()
        with _host_seconds(stream, ["_fill"]) as host:
            t0 = time.perf_counter()
            res = stream_join(inner.keys, inner.vals, ok, ov, chunk,
                              device=dev)
            dt = time.perf_counter() - t0
        d = _delta(before)
        bad = [c.index for c in res.chunks if c.join_tuples != c.rows]
        if res.join_tuples != no or len(res.chunks) != 16 or bad:
            raise AssertionError(f"stream: join_tuples {res.join_tuples} != "
                                 f"{no}, {len(res.chunks)} chunks, chunks "
                                 f"{bad} off")
        if d["flat_to_rows"] == 0 or d["merge_probe_gather"] == 0:
            raise AssertionError(f"stream: K1/K3 not launched: {d}")
        _print(f"phase outofcore: stream_join {ni} x {no} run {run}: "
               f"{dt:.6f} s = {no / dt:.1f} probe-tuples/s; join_tuples "
               f"{res.join_tuples} exact (the probe row count: every row "
               f"picks one of {ni} distinct build keys); {len(res.chunks)} "
               f"chunks of {chunk}, window {res.plan.window}, tile "
               f"{res.plan.tile}, probe_chunks {res.plan.probe_chunks}; "
               f"{_transfer_line(res)}; host copies into the pinned "
               f"buffers {host['_fill']:.3f} s; launches {d}")
    _print(f"phase outofcore: stream data: build generated in {gen_s:.3f} "
           f"s, probe picks on the card and copied to host RAM in "
           f"{pick_s:.3f} s")


def _chunk_rows(store):
    """on_chunk: the matched rows of a live chunk (unique build keys)."""
    from hash_join_codes_knl_tpu_torch.engine.phj import materialize

    def on_chunk(cm, res):
        store.append(materialize(res))
    return on_chunk


def _outofcore_resume(dev, want) -> None:
    """Stream resume at 4M x 64M, chunks of 16M, with a spill directory:
    the first run's rows, then a rerun after one chunk's match file is
    corrupted (3 chunks resume, their probe columns replayed on the card;
    1 recomputes): both digests against join_oracle's (`want`, a future
    from the merge path's host threads, same relation)."""
    from hash_join_codes_knl_tpu_torch.engine.oracle import multiset_digest
    from hash_join_codes_knl_tpu_torch.engine.stream import (
        SpilledChunk,
        replay_probe_columns,
        stream_join,
    )

    ni, no, chunk = RESUME
    (inner, outer), _ = _generate(ni, no, seed=42, mode="uniform")
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    with tempfile.TemporaryDirectory() as d:
        live = []
        first = stream_join(*cols, chunk, spill_dir=d, device=dev,
                            on_chunk=_chunk_rows(live))
        with open(os.path.join(d, "chunk_000002_mval.bin"), "r+b") as f:
            f.seek(4 * 12345)
            byte = f.read(1)[0]
            f.seek(4 * 12345)
            f.write(bytes([byte ^ 0xFF]))
        rows = []
        live_cb = _chunk_rows(rows)

        def on_chunk(cm, payload):
            if not isinstance(payload, SpilledChunk):
                return live_cb(cm, payload)
            sl = slice(cm.index * chunk, (cm.index + 1) * chunk)
            pk, pv = replay_probe_columns(outer.keys[sl], outer.vals[sl],
                                          first.plan,
                                          len(payload.match_vals), dev)
            m = payload.match_cnts == 1
            rows.append((pk[m], pv[m], payload.match_vals[m]))

        t0 = time.perf_counter()
        second = stream_join(*cols, chunk, spill_dir=d, device=dev,
                             on_chunk=on_chunk)
        dt = time.perf_counter() - t0
    resumed = [c.resumed for c in second.chunks]
    digests = [multiset_digest(*(np.concatenate(c) for c in zip(*r)))
               for r in (live, rows)]
    want = want.result()
    if resumed != [True, True, False, True] or digests != [want, want] or \
            second.join_tuples != first.join_tuples:
        raise AssertionError(f"stream resume: resumed {resumed}, digests "
                             f"{digests} against the oracle's {want}")
    _print(f"phase outofcore: stream resume {ni} x {no}, chunks of {chunk}: "
           f"after corrupting chunk 2's match file, resumed {resumed} "
           f"(rerun {dt:.3f} s with the replays); the live run's rows and "
           f"the rerun's (3 replayed, 1 live) both digest to join_oracle's "
           f"{want}")


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


# grace_join's host steps, timed from outside: the input fingerprints,
# the wait for each pass and the copy of its live rows to the host, the
# file appends (with their checksums), the host skew split, the phase-2
# file reads
GRACE_SPLIT = ["_side_fingerprint", "_device_fragments", "_append_fragments",
               "_host_partition_fragments", "_read_u32"]


def _outofcore_grace(dev) -> None:
    """grace_join at the grace_join_256Mx1000M row's shape (f_bits 6,
    chunks of 32M), then a rerun on the same spill directory: both sides
    reused, every partition resumed from the journal.  The probe side is
    cut only where the temp directory's disk or the host's memory cannot
    hold it (printed)."""
    from hash_join_codes_knl_tpu_torch.engine import grace, stream
    from hash_join_codes_knl_tpu_torch.engine.grace import grace_join

    ni, no, f_bits, chunk = GRACE
    root = tempfile.gettempdir()
    free, avail = shutil.disk_usage(root).free, _mem_available()
    # partition files: 8 bytes a row of both sides; host arrays the same
    fit = min(free - 2**30, avail - 16 * 2**30) // 8 - ni
    _print(f"phase outofcore: grace temp dir {root}: {free / 2**30:.1f} GiB "
           f"free on its disk, {avail / 2**30:.1f} GiB of host memory "
           f"available; the files need {8 * (ni + no) / 2**30:.1f} GiB")
    if fit < no:
        no = max(ni, int(fit) // chunk * chunk)
        _print(f"phase outofcore: grace probe side CUT to {no} rows to fit")
    t0 = time.perf_counter()
    ik, iv, ok, ov = grace_data(dev, ni, no)
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        runs = []
        for _ in range(2):
            before = _launches()
            torch.cuda.synchronize()
            with _host_seconds(grace, GRACE_SPLIT) as host, \
                    _host_seconds(stream, ["_fill"]) as fill:
                t0 = time.perf_counter()
                res = grace_join(ik, iv, ok, ov, f_bits=f_bits,
                                 chunk_rows=chunk, spill_dir=d, device=dev)
                dt = time.perf_counter() - t0
            split = {k: round(v, 3) for k, v in {**host, **fill}.items()}
            runs.append((dt, res, _delta(before), split))
        spill_gb = sum(e.stat().st_size for e in os.scandir(d)) / 1e9
    (dt, res, d1, split), (dt2, res2, _, split2) = runs
    F = 1 << f_bits
    n_live = sum(1 for m in res.partitions if m.build_rows and m.probe_rows)
    chunks = -(-ni // chunk) + -(-no // chunk)
    probe_kernels = {k: d1[k] for k in ("merge_probe", "merge_probe_gather")}
    if res.join_tuples != no or res.reused_sides != {"build": False,
                                                     "probe": False}:
        raise AssertionError(f"grace: join_tuples {res.join_tuples} != {no} "
                             f"or sides reused {res.reused_sides}")
    if d1["radix_partition"] < chunks or not sum(probe_kernels.values()):
        raise AssertionError(f"grace: the radix pass or the partition "
                             f"probes not launched: {d1}")
    if res2.join_tuples != no or res2.resumed_partitions != n_live or \
            res2.reused_sides != {"build": True, "probe": True}:
        raise AssertionError(f"grace rerun: {res2.join_tuples} tuples, "
                             f"{res2.resumed_partitions} of {n_live} resumed, "
                             f"sides reused {res2.reused_sides}")
    _print(f"phase outofcore: grace_join {ni} x {no}, f_bits {f_bits}, "
           f"chunks of {chunk}: {dt:.3f} s (partition "
           f"{res.seconds['partition']:.3f} s, join "
           f"{res.seconds['join']:.3f} s) = {no / dt:.1f} probe-tuples/s; "
           f"join_tuples {res.join_tuples} exact (every probe row picks one "
           f"distinct build key); {F} partitions, largest build "
           f"{max(m.build_rows for m in res.partitions)}, largest probe "
           f"{max(m.probe_rows for m in res.partitions)}; {spill_gb:.3f} GB "
           f"of partition files; radix-pass launches {d1['radix_partition']} "
           f"for {chunks} chunks; chunks on the host skew path "
           f"{res.host_skew_chunks}; partition probes {probe_kernels}; data "
           f"made in {gen_s:.3f} s; host seconds inside {split}")
    _print(f"phase outofcore: grace rerun on the same spill dir: {dt2:.3f} s "
           f"(partition {res2.seconds['partition']:.3f} s, join "
           f"{res2.seconds['join']:.3f} s); sides reused "
           f"{res2.reused_sides}, {res2.resumed_partitions} of {n_live} live "
           f"partitions resumed from the journal, join_tuples "
           f"{res2.join_tuples}; host seconds inside {split2}")


def _outofcore_cli() -> None:
    """Both out-of-core CLI modes through cli.main at 4M x 64M (generated
    in memory, seed 42); join_tuples against the generator's count."""
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples

    ni, no = RESUME[:2]
    want = expected_join_tuples(ni, no)
    with tempfile.TemporaryDirectory() as tmp:
        for extra in (["--stream-chunk-rows", str(RESUME[2]), "--spill-dir",
                       os.path.join(tmp, "stream")],
                      ["--grace-bits", "4", "--spill-dir",
                       os.path.join(tmp, "grace")]):
            argv = ["phj", "1", str(no), str(ni), "--json", "--dir", tmp,
                    *extra]
            _, out, _ = _cli(argv)
            if out["join_tuples"] != want:
                raise AssertionError(f"cli {argv}: join_tuples "
                                     f"{out['join_tuples']} != {want}")
            _print(f"phase outofcore: cli {' '.join(argv[:4] + extra[:2])}: "
                   f"{out}")


def _pair_oracle(ik: np.ndarray, ok: np.ndarray):
    """(outer index << 32 | inner index) of every matching pair, sorted,
    and each outer row's match count, from np.searchsorted."""
    order = np.argsort(ik, kind="stable")
    sk = ik[order]
    lo = np.searchsorted(sk, ok, "left")
    cnt = np.searchsorted(sk, ok, "right") - lo
    o = np.repeat(np.arange(len(ok), dtype=np.uint64), cnt)
    first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    i = order[first + np.arange(len(o))].astype(np.uint64)
    return np.sort(o << np.uint64(32) | i), cnt


def _pairs(out) -> np.ndarray:
    return np.sort(out["ov"].astype(np.uint64) << np.uint64(32)
                   | out["iv"].astype(np.uint64))


def _outofcore_columns(dev) -> None:
    """join_columns at 1M x 8M on an M:N build (the keys drawn from a
    domain of 500K), a quarter of the probes drawn from the whole domain
    (some miss), the four modes; then join_columns_u64 and a two-column
    join_columns_multi; each against the searchsorted oracle: the sorted
    (outer row, inner row) pairs, and the outer rows with and without a
    match."""
    from hash_join_codes_knl_tpu_torch.engine.columns import (
        join_columns,
        join_columns_multi,
        join_columns_u64,
    )

    ni, no = COLUMNS
    rng = np.random.default_rng(45)

    def mn(domain):
        keys = domain[rng.integers(0, domain.size, ni)]
        probe = np.concatenate([keys[rng.integers(0, ni, no * 3 // 4)],
                                domain[rng.integers(0, domain.size,
                                                    no - no * 3 // 4)]])
        return keys, probe

    ik, ok = mn(rng.integers(1, 2**32, 500_000, dtype=np.uint32))
    inner_cols = {"iv": np.arange(ni, dtype=np.int64),
                  "w": rng.random(ni)}
    outer_cols = {"ov": np.arange(no, dtype=np.int64)}
    want, cnt = _pair_oracle(ik, ok)
    semi, anti = np.flatnonzero(cnt > 0), np.flatnonzero(cnt == 0)
    times = {}
    for how in ("inner", "left", "semi", "anti"):
        t0 = time.perf_counter()
        out, _ = join_columns(ik, inner_cols, ok, outer_cols, how=how,
                              left_fill=-1, device=dev)
        times[how] = round(time.perf_counter() - t0, 3)
        if how in ("semi", "anti"):
            same = np.array_equal(np.sort(out["ov"]),
                                  semi if how == "semi" else anti)
        else:
            m = out["iv"] >= 0
            same = (np.array_equal(_pairs({k: v[m] for k, v in out.items()}),
                                   want)
                    and np.array_equal(out["w"][m],
                                       inner_cols["w"][out["iv"][m]])
                    and np.array_equal(np.sort(out["ov"][~m]),
                                       anti if how == "left" else anti[:0]))
        if not same:
            raise AssertionError(f"join_columns how={how} differs from the "
                                 "searchsorted oracle")
    ik64, ok64 = mn(rng.integers(1, 2**64, 500_000, dtype=np.uint64))
    t0 = time.perf_counter()
    out, _ = join_columns_u64(ik64, {"iv": np.arange(ni)}, ok64,
                              {"ov": np.arange(no)}, device=dev)
    times["u64"] = round(time.perf_counter() - t0, 3)
    want64, _ = _pair_oracle(ik64, ok64)
    a = rng.integers(0, 2**20, 500_000).astype(np.int32)
    b = rng.integers(-2**20, 2**20, 500_000).astype(np.int64)
    tup = (a.astype(np.uint64) << np.uint64(32)) | (b + 2**20).astype(
        np.uint64)
    ikt, okt = mn(np.arange(tup.size))
    t0 = time.perf_counter()
    out_m, _ = join_columns_multi((a[ikt], b[ikt]), {"iv": np.arange(ni)},
                                  (a[okt], b[okt]), {"ov": np.arange(no)},
                                  device=dev)
    times["multi"] = round(time.perf_counter() - t0, 3)
    want_m, _ = _pair_oracle(tup[ikt], tup[okt])
    if not (np.array_equal(_pairs(out), want64)
            and np.array_equal(_pairs(out_m), want_m)):
        raise AssertionError("join_columns_u64 or join_columns_multi differs "
                             "from the searchsorted oracle")
    _print(f"phase outofcore: join_columns {ni} x {no} M:N ({want.size} "
           f"pairs, {anti.size} unmatched outer rows), inner/left/semi/anti, "
           f"join_columns_u64 ({want64.size} pairs) and two-column "
           f"join_columns_multi ({want_m.size} pairs) equal the searchsorted "
           f"oracle; seconds {times}")


def phase_outofcore(dev, want_4m) -> None:
    """The out-of-core slice's path: stream_join, its resume, grace_join
    and its rerun, both CLI modes, the multi-column joins."""
    _outofcore_stream(dev)
    _stamp("the stream join")
    torch.cuda.empty_cache()
    _outofcore_resume(dev, want_4m)
    _stamp("the stream resume")
    _outofcore_grace(dev)
    _stamp("the Grace join")
    torch.cuda.empty_cache()
    _outofcore_cli()
    _stamp("the out-of-core CLI runs")
    _outofcore_columns(dev)
    _stamp("the multi-column joins")



DIST_GRACE = (16_000_000, 64_000_000, 4)  # build, probe, f_bits
DIST_RANKS = 4  # thread ranks sharing the card


def _digest_chunked(data, pool, parts: int = 16):
    """join_oracle's digest of a relation pair, computed over `parts`
    slices of the probe side on the host pool: the digest is a sum over
    rows, so the slices' digests add up to the whole's, and each slice
    goes to join_oracle sorted by key (the same rows; its searches then
    walk the build keys in order).  Returns a function that waits for
    it."""
    from hash_join_codes_knl_tpu_torch.engine.oracle import (
        join_oracle,
        multiset_digest,
    )

    inner, outer = data

    def piece(a, b):
        ok, ov = outer.keys[a:b], outer.vals[a:b]
        o = np.argsort(ok, kind="stable")
        return multiset_digest(*join_oracle(inner.keys, inner.vals, ok[o],
                                            ov[o]))

    cuts = np.linspace(0, len(outer.keys), parts + 1).astype(np.int64)
    futs = [pool.submit(piece, a, b)
            for a, b in zip(cuts[:-1].tolist(), cuts[1:].tolist())]
    return lambda: _sum_digests([f.result() for f in futs])


def _sum_digests(ds):
    return (sum(d[0] for d in ds), sum(d[1] for d in ds) % 2**64,
            sum(d[2] for d in ds) % 2**64)


def _rows_digest(pool, results, heavy=()):
    """multiset_digest of the matched rows of every rank's JoinResult and
    of the heavy row sets (probe keys, values, match values, counts),
    the rows selected on the card and digested in slices on the host
    pool."""
    from hash_join_codes_knl_tpu_torch.engine.oracle import multiset_digest
    from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

    sets = [(r.probe_keys, r.probe_vals, r.match_vals, r.match_cnts)
            for r in results] + list(heavy)
    futs = []
    for k, v, t, c in sets:
        if c.numel() and int(c.max()) > 1:
            raise AssertionError("multi-match rows in a unique-build join")
        m = c == 1
        cols = [to_numpy_u32(x[m]) for x in (k, v, t)]
        for part in np.array_split(np.arange(len(cols[0])), 4):
            if len(part):
                a, b = int(part[0]), int(part[-1]) + 1
                futs.append(pool.submit(multiset_digest,
                                        *(x[a:b] for x in cols)))
    return _sum_digests([f.result() for f in futs])


def _timed(dev, fn):
    """(fn(), host seconds fenced by synchronizes, peak device GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(dev) / 2**30)


def _dist_one_rank(dev, pool, data_h, zipf_h, head_med):
    """A world of one NCCL rank (a FileStore in a temp dir) at the cpra
    bench row's shape: cpra_join (the shortcut to join()), timed before
    the oracle's digests start on the host pool; its full skew step on
    the Zipf twin; the CLI's staged cpra; npj_join_dist against
    npj_join.  Returns the wait for the uniform relations' digest."""
    import torch.distributed as dist

    from hash_join_codes_knl_tpu_torch.engine.npj import npj_join
    from hash_join_codes_knl_tpu_torch.parallel.cpra import cpra_join
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        data_mesh,
        initialize,
    )
    from hash_join_codes_knl_tpu_torch.parallel.npj_dist import (
        npj_join_dist,
    )
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples
    from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

    cols = [c for rel in data_h for c in (rel.keys, rel.vals)]
    store = tempfile.mkdtemp()
    initialize(f"file://{store}/store", world_size=1, rank=0,
               backend="nccl")
    try:
        mesh = data_mesh(device=dev)
        if mesh.size != 1 or dist.get_backend() != "nccl":
            raise AssertionError(f"not a world of one NCCL rank: {mesh}")
        (res, plan), dt0, peak = _timed(dev, lambda: cpra_join(*cols, mesh))
        got, want = int(res.join_tuples), expected_join_tuples(*HEADLINE)
        if got != want:
            raise AssertionError(f"cpra_join one rank: {got} != {want}")
        del res
        med, runs = _median_s(lambda: cpra_join(*cols, mesh, plan))
        _print(f"phase distributed: one NCCL rank, cpra_join 16M x 256M "
               f"(host columns, the shortcut to join()): join_tuples {got} "
               f"exact; first {dt0:.3f} s; median of 3 {med:.6f} s (runs "
               f"{runs}, upload of the host columns included) beside the "
               f"merge headline's {head_med:.6f} s on device columns; peak "
               f"{peak:.2f} GiB")
        # the oracle's digests run on the host from here on
        want_z = _digest_chunked(zipf_h, pool)
        want_h = _digest_chunked(data_h, pool)
        zcols = [c for rel in zipf_h for c in (rel.keys, rel.vals)]
        (res, heavy, _), dt, peak = _timed(dev, lambda: cpra_join(
            *zcols, mesh, skew=True))
        n_heavy = int((heavy[3] > 0).sum())
        got_z = _rows_digest(pool, [res], [heavy])
        del res, heavy
        _print(f"phase distributed: one NCCL rank, cpra_join(skew=True) "
               f"16M x 256M Zipf z=1.0: {got_z[0]} rows, {n_heavy} joined "
               f"through the replicated heavy table; {dt:.3f} s; peak "
               f"{peak:.2f} GiB")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _, out, _ = _cli(["cpra", "1", str(HEADLINE[1]), str(HEADLINE[0]),
                          "--json", "--timelog"])
        wall = time.perf_counter() - t0
        if out["join_tuples"] != expected_join_tuples(*HEADLINE):
            raise AssertionError(f"cli cpra 1: {out}")
        _print(f"phase distributed: cli cpra 1 {HEADLINE[1]} {HEADLINE[0]} "
               f"--json --timelog: join_tuples {out['join_tuples']} exact; "
               f"exchange {out['exchange_s']} s, local_join "
               f"{out['local_join_s']} s ({wall:.3f} s with generation)")
        torch.cuda.empty_cache()
        data_n, _ = _generate(*NPJ_4M, seed=42, mode="uniform")
        ncols = [c for rel in data_n for c in (rel.keys, rel.vals)]
        (mv, mc, total, _), dt, peak = _timed(dev, lambda: npj_join_dist(
            *ncols, mesh))
        wv, wc, _ = npj_join(*ncols, device=dev)
        if not (np.array_equal(mv, to_numpy_u32(wv))
                and np.array_equal(mc, wc.cpu().numpy())
                and total == expected_join_tuples(*NPJ_4M)):
            raise AssertionError("npj_join_dist one rank differs from "
                                 "npj_join")
        _print(f"phase distributed: one NCCL rank, npj_join_dist 4M x 16M: "
               f"match columns equal npj_join's, join_tuples {total}; "
               f"{dt:.3f} s; peak {peak:.2f} GiB")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    if got_z != want_z():
        raise AssertionError(f"cpra_join skew one rank: {got_z} != "
                             f"{want_z()}")
    _print(f"phase distributed: one NCCL rank, the skew run's light + heavy "
           f"rows digest equals join_oracle's ({got_z[0]} rows)")
    return want_h


def _on_ranks(meshes, fn):
    from hash_join_codes_knl_tpu_torch.parallel.distributed import run_ranks

    return run_ranks(meshes, fn, timeout_s=900)


def _dist_threads(dev, pool, meshes, data_h, want_h, uni_4m, want_4m,
                  zipf_4m, want_z4m) -> dict:
    """Four gloo thread ranks on the card: cpra_join at 16M x 256M in
    total, the 4M x 64M variants (radix pack, tier routing, skew,
    pipelined, two-level, a padded radix local plan), npj_join_dist,
    grace_join_dist and its resume.  Returns the inputs the kernel
    checks need."""
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.npj import npj_join
    from hash_join_codes_knl_tpu_torch.parallel import cpra
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        shard_null_padded,
    )
    from hash_join_codes_knl_tpu_torch.parallel.grace_dist import (
        grace_join_dist,
    )
    from hash_join_codes_knl_tpu_torch.parallel.npj_dist import (
        npj_join_dist,
    )
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples
    from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

    W = len(meshes)
    head = [c for rel in data_h for c in (rel.keys, rel.vals)]
    out, dt, peak = _timed(dev, lambda: _on_ranks(
        meshes, lambda m: cpra.cpra_join(*head, m)[0]))
    got = _rows_digest(pool, out)
    if got != want_h() or got[0] != expected_join_tuples(*HEADLINE):
        raise AssertionError(f"cpra_join {W} ranks 16M x 256M: {got} != "
                             f"{want_h()}")
    _print(f"phase distributed: {W} thread ranks (gloo), "
           f"cpra_join 16M x 256M sort pack: the ranks' rows digest equal "
           f"join_oracle's ({got[0]} rows, exact); {dt:.3f} s; peak "
           f"{peak:.2f} GiB; rows per rank "
           f"{[int(r.join_tuples) for r in out]}")
    del out
    torch.cuda.empty_cache()
    u4 = [c for rel in uni_4m for c in (rel.keys, rel.vals)]
    z4 = [c for rel in zipf_4m for c in (rel.keys, rel.vals)]
    ni, no = HEADLINE_4M
    padded = dataclasses.replace(_radix_4096_plan(), tile=2048)
    # level caps: twice the expected rows per (source, destination)
    cap2 = (2 * ni // W, 2 * no // W)

    def staged(m):
        plan = m.root_call(plan_join, ni // W, no // W, device=m.device)
        ex, jo = cpra.make_cpra_steps_staged(m, plan, 2 * ni // W**2,
                                             2 * no // W**2)
        args = [shard_null_padded(c, m) for c in u4]
        t0 = time.perf_counter()
        *xch, eovf = ex(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res, jovf = jo(*xch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return res, (eovf or jovf), t1 - t0, t2 - t1

    runs = {
        "radix pack": lambda m: cpra.cpra_join(*u4, m, pack_impl="radix")[0],
        "tier_ratio 0.75": lambda m: cpra.cpra_join(*u4, m,
                                                    tier_ratio=0.75)[0],
        "pipelined, 4 chunks": lambda m: _pipelined(m, u4, W),
        "2-level 2 x 2": lambda m: _two_level(m, u4, W, cap2),
        "padded radix 4096-way local plan": lambda m: cpra.cpra_join(
            *u4, m, padded)[0],
    }
    for label, fn in runs.items():
        res, dt, peak = _timed(dev, lambda: _on_ranks(meshes, fn))
        got = _rows_digest(pool, res)
        if got != want_4m:
            raise AssertionError(f"{label} {W} ranks 4M x 64M: {got} != "
                                 f"{want_4m}")
        _print(f"phase distributed: {W} thread ranks, cpra {label} 4M x "
               f"64M: digest equals join_oracle's ({got[0]} rows); "
               f"{dt:.3f} s; peak {peak:.2f} GiB")
        del res
    out, dt, peak = _timed(dev, lambda: _on_ranks(
        meshes, lambda m: cpra.cpra_join(*z4, m, skew=True)))
    got = _rows_digest(pool, [o[0] for o in out], [o[1] for o in out])
    if got != want_z4m:
        raise AssertionError(f"skew {W} ranks 4M x 64M: {got} != {want_z4m}")
    _print(f"phase distributed: {W} thread ranks, cpra skew 4M x 64M Zipf "
           f"z=1.0: light + heavy digest equals join_oracle's ({got[0]} "
           f"rows, {sum(int((o[1][3] > 0).sum()) for o in out)} heavy); "
           f"{dt:.3f} s; peak {peak:.2f} GiB")
    del out
    out = _on_ranks(meshes, staged)
    if any(o[1] for o in out) or _rows_digest(pool, [o[0] for o in out]) \
            != want_4m:
        raise AssertionError("staged cpra 4M x 64M overflowed or differs")
    _print(f"phase distributed: {W} thread ranks, staged cpra 4M x 64M: "
           f"digest equals the oracle's; per rank exchange s (gloo: "
           f"copies through host memory and loopback TCP, not an "
           f"interconnect) "
           f"{[round(o[2], 4) for o in out]}, local_join s "
           f"{[round(o[3], 4) for o in out]}")
    del out
    torch.cuda.empty_cache()
    data_n, _ = _generate(*NPJ_4M, seed=42, mode="uniform")
    ncols = [c for rel in data_n for c in (rel.keys, rel.vals)]
    out, dt, peak = _timed(dev, lambda: _on_ranks(
        meshes, lambda m: npj_join_dist(*ncols, m)))
    wv, wc, _ = npj_join(*ncols, device=dev)
    wv, wc = to_numpy_u32(wv), wc.cpu().numpy()
    if not all(np.array_equal(o[0], wv) and np.array_equal(o[1], wc)
               for o in out):
        raise AssertionError("npj_join_dist 4 ranks differs from npj_join")
    _print(f"phase distributed: {W} thread ranks, npj_join_dist 4M x 16M: "
           f"match columns equal npj_join's on every rank, join_tuples "
           f"{out[0][2]}; {dt:.3f} s; peak {peak:.2f} GiB")
    del out
    torch.cuda.empty_cache()
    gi, gp, f_bits = DIST_GRACE
    ik, iv, ok, ov = grace_data(dev, gi, gp)
    with tempfile.TemporaryDirectory() as tmp:
        grace = lambda m: grace_join_dist(ik, iv, ok, ov, m, f_bits=f_bits,
                                          spill_dir=tmp)
        first, dt, peak = _timed(dev, lambda: _on_ranks(meshes, grace))
        again, dt2, _ = _timed(dev, lambda: _on_ranks(meshes, grace))
    live = sum(1 for p in first[0].partitions
               if p.build_rows and p.probe_rows)
    if not all(r.join_tuples == gp for r in first + again) or not all(
            r.reused_sides == {"build": True, "probe": True}
            and r.resumed_partitions == live for r in again):
        raise AssertionError(f"grace_join_dist: {first[0]} / {again[0]}")
    _print(f"phase distributed: {W} thread ranks, grace_join_dist 16M x 64M "
           f"f_bits {f_bits}: join_tuples {gp} exact; {dt:.3f} s (partition "
           f"{first[0].seconds['partition']:.3f} s, join "
           f"{first[0].seconds['join']:.3f} s on rank 0); peak {peak:.2f} "
           f"GiB; rerun {dt2:.3f} s, both sides reused and {live} "
           f"partitions resumed on every rank")
    return {"u4": u4, "ncols": ncols}


def _pipelined(m, cols, W):
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.parallel import cpra
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        shard_null_padded,
    )

    ni, no = len(cols[0]), len(cols[2])
    plan = m.root_call(plan_join, ni // W, no // W, device=m.device)
    step = cpra.make_cpra_step_pipelined(
        m, plan, max(64, 4 * ni // W**2),
        max(plan.tile * 4, 4 * no // W**2), 4)
    res, ovf = step(*[shard_null_padded(c, m) for c in cols])
    if ovf:
        raise AssertionError("pipelined cpra overflowed")
    return res


def _two_level(m, cols, W, caps):
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.parallel import cpra
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        shard_null_padded,
        split_2level,
    )

    ni, no = len(cols[0]), len(cols[2])
    plan = m.root_call(plan_join, ni // W, no // W, device=m.device)
    h, c = split_2level(m, 2)
    res, ovf = cpra.make_cpra_step_2level(h, c, plan, *caps)(
        *[shard_null_padded(x, m) for x in cols])
    if ovf:
        raise AssertionError("2-level cpra overflowed")
    return res


def _dist_kernel_checks(meshes, inputs) -> dict:
    """Each kernel the distributed path launched, held against its plain
    version on rank 0's inputs there: the radix pack's pass and its
    scramble on rank 0's probe block; K1, K3 and K2 on rank 0's
    exchanged columns at the local plan (256 spread tiles for the
    probes); the tile probe on the padded radix local plan's layout of
    those columns; K2 on NPJ's table against rank 0's probe block.  Runs
    after the path's counts are read.  Returns the largest difference per
    kernel."""
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine import phj
    from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
    from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg
    from hash_join_codes_knl_tpu_torch.ops import probe as pt
    from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp
    from hash_join_codes_knl_tpu_torch.ops import scramble as sc
    from hash_join_codes_knl_tpu_torch.parallel import cpra
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        shard_null_padded,
    )
    from hash_join_codes_knl_tpu_torch.utils.hashing import (
        BIAS,
        bias,
        hashed_key,
    )

    W = len(meshes)
    u4 = inputs["u4"]
    ni, no = HEADLINE_4M

    def exchanged(m):
        plan = m.root_call(plan_join, ni // W, no // W, device=m.device)
        ex, _ = cpra.make_cpra_steps_staged(m, plan, 2 * ni // W**2,
                                            2 * no // W**2)
        return plan, ex(*[shard_null_padded(c, m) for c in u4])[:4]

    plan, xch = _on_ranks(meshes, exchanged)[0]
    errs = {}
    # the radix pack's pass on rank 0's probe block (2 owner bits)
    ok0, ov0 = (shard_null_padded(c, meshes[0]) for c in u4[2:])
    args = (bias(hashed_key(ok0, plan.factor)), ov0, 2, 0,
            2 * no // W**2)
    got, want = rp.radix_partition(*args), rp.radix_partition_torch(*args)
    _check_equal("radix_partition, the radix pack of rank 0", got, want)
    errs["radix_partition"] = _max_abs_err(got, want)
    sargs = (ok0, plan.factor, 0, BIAS)
    got, want = [sc.mul_u32(*sargs)], [sc.mul_u32_torch(*sargs)]
    _check_equal("mul_u32, the radix pack's scramble of rank 0", got, want)
    errs["mul_u32"] = _max_abs_err(got, want)
    local = dataclasses.replace(plan, skip_bits=plan.skip_bits + 2)
    tile, window, rows, cap = phj._merge_params(local, xch[0].shape[0],
                                                xch[2].shape[0])
    k1 = (xch[2], xch[3], cap, max(1, local.probe_chunks), local.factor)
    got, want = cl.flat_to_rows(*k1), cl.flat_to_rows_torch(*k1)
    _check_equal("flat_to_rows, rank 0's exchanged probe side", got, want)
    errs["flat_to_rows"] = _max_abs_err(got, want)
    bhk, bval, ohk, _, wrow, tile, window = _stages(xch, local)
    n_tiles = ohk.shape[0] // tile
    sel = torch.linspace(0, n_tiles - 1, 256, device=ohk.device).long()
    sub = (ohk.view(n_tiles, tile)[sel].reshape(-1).contiguous(), bhk, bval,
           wrow[sel].contiguous(), tile, window)
    want = mp.merge_probe_torch(*sub)
    for name, fn in (("merge_probe_gather", mg.merge_probe_gather),
                     ("merge_probe", mp.merge_probe)):
        got = fn(*sub)
        _check_equal(f"{name}, rank 0's local join (256 tiles)", got, want)
        errs[name] = _max_abs_err(got, want)
    padded = dataclasses.replace(_radix_4096_plan(), tile=2048,
                                 skip_bits=2)
    lay = _padded_stages(*xch, padded)
    pk_s, tp_s, _ = _spread_tiles(lay["pk"], lay["tpid"], 128, 256)
    sub = (pk_s, lay["tk"], lay["tv"], tp_s, 128)
    got, want = pt.probe_tiles(*sub), pt.probe_tiles_torch(*sub)
    _check_equal("probe_tiles, rank 0's padded radix local plan", got, want)
    errs["probe_tiles"] = _max_abs_err(got, want)
    # K2 on NPJ's replicated table against rank 0's probe block
    from hash_join_codes_knl_tpu_torch.engine.npj import plan_npj
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

    ncols = inputs["ncols"]
    dev = meshes[0].device
    nplan = plan_npj(len(ncols[0]))
    nplan = dataclasses.replace(nplan, window=nplan.auto_window(
        len(ncols[2]) // W))
    ohk, tk, tv, wrow, tile, window = npj_probe_inputs(
        (u32_to_device(ncols[0], dev), u32_to_device(ncols[1], dev),
         shard_null_padded(ncols[2], meshes[0]), None), nplan)
    n_tiles = ohk.shape[0] // tile
    sel = torch.linspace(0, n_tiles - 1, 256, device=dev).long()
    sub = (ohk.view(n_tiles, tile)[sel].reshape(-1).contiguous(), tk, tv,
           wrow[sel].contiguous(), tile, window)
    got, want = mp.merge_probe(*sub), mp.merge_probe_torch(*sub)
    _check_equal("merge_probe, NPJ's table vs rank 0's block", got, want)
    errs["merge_probe"] = max(errs["merge_probe"], _max_abs_err(got, want))
    _print(f"phase distributed: kernels equal to their plain versions at "
           f"the distributed path's shapes (local plan {local}; padded "
           f"{padded}): max abs err {errs}")
    return errs


def phase_distributed(dev, head_med, data_h, zipf_h, want_4m, want_z4m,
                      uni_4m, zipf_4m) -> dict:
    """The distributed slice's path on the headline's host relations and
    its Zipf twin: a world of one NCCL rank, then four gloo thread ranks
    sharing the card.  Returns the inputs the kernel checks need."""
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        thread_meshes,
    )

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)
    try:
        want_h = _dist_one_rank(dev, pool, data_h, zipf_h, head_med)
        _stamp("the distributed phase's NCCL rank")
        torch.cuda.empty_cache()
        meshes = thread_meshes(DIST_RANKS, dev, timeout_s=900)
        inputs = _dist_threads(dev, pool, meshes, data_h, want_h, uni_4m,
                               want_4m, zipf_4m, want_z4m)
        inputs["meshes"] = meshes
        inputs["want_h"] = want_h()  # the fuzz phase's uniform draws read it
    finally:
        pool.shutdown(wait=True)
    _stamp("the distributed phase's thread ranks")
    return inputs


# --- the fuzz phase: the randomized differential campaigns of
# tests/test_fuzz.py (tests/torch_fuzz_cases.py) on the card, then
# full-width draws of random plan geometry

FUZZ_SEED = 1107  # the full-width draws' plans, relations and hot key
FUZZ_TILES = (1024, 1536, 2048, 2560, 3072)


def _fuzz_small(dev, tmp) -> dict:
    """Every draw of tests/torch_fuzz_cases.py on the card against the
    same draw on the CPU (every output, slot for slot, final plans
    included) and against the port's oracle (card_vs_cpu there).  The
    CPU half launches nothing: a wrapper launches only on a CUDA tensor.
    Returns the draws run by campaign."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_fuzz_cases as fz

    from hash_join_codes_knl_tpu_torch.engine.oracle import (
        join_oracle,
        multiset_digest,
    )

    done: dict = {}
    for campaign, seed in fz.all_draws():
        before = _launches()
        if not fz.card_vs_cpu(campaign, seed, dev,
                              os.path.join(tmp, f"{campaign}_{seed}"),
                              join_oracle, multiset_digest):
            continue  # a side cut empty for its ranks (test_fuzz skips it)
        launched = _delta(before)
        done.setdefault(campaign, []).append(seed)
        _print(f"phase fuzz: {campaign} seed {seed}: card equals CPU and "
               f"the oracle; launches "
               f"{ {k: n for k, n in launched.items() if n} }")
    return done


def _fuzz_plan(rng):
    """plan_join at the headline shape with a random tile and chunk count
    (the tuner's candidates and below, at most the window cap's c_win);
    the window auto."""
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.tune import DEFAULT_CANDIDATES

    ni, no = HEADLINE
    tile = int(rng.choice(FUZZ_TILES))
    c_win = (12_500 * no) // (tile * ni)
    pool = tuple(range(8, min(DEFAULT_CANDIDATES), 8)) + DEFAULT_CANDIDATES
    chunks = int(rng.choice([c for c in pool if c <= c_win]))
    return plan_join(ni, no, tile=tile, probe_chunks=chunks)


def _fuzz_wide_join(dev, pool, label, data, plan, want) -> tuple:
    """join() of a full-width draw on the card: the cardinality and the
    matched rows' digest (selected on the card, digested on the host
    pool) against the oracle's digest.  Returns (columns, final plan)."""
    from hash_join_codes_knl_tpu_torch.engine.phj import join

    cols = _device_cols(data, dev)
    before = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, final = join(*cols, plan)
    got_n = int(res.join_tuples)
    dt = time.perf_counter() - t0
    d = _delta(before)
    got = _rows_digest(pool, [res])
    del res
    want = want() if callable(want) else want
    if got_n != want[0] or got != want:
        raise AssertionError(f"fuzz {label}: join_tuples {got_n}, digest "
                             f"{got} != oracle {want}")
    _print(f"phase fuzz: {label} {HEADLINE[0]} x {HEADLINE[1]}: "
           f"join_tuples {got_n} and the "
           f"rows' digest equal the oracle's; {dt:.3f} s incl. re-plans; "
           f"plan {plan} -> final {final}; launches "
           f"{ {k: n for k, n in d.items() if n} }")
    return cols, final


def _fuzz_relations(rng, data_h):
    """The full-width draws' new relations: a Zipf 0.75 pair and the
    heavy-hitter pair (a random share of the uniform probe side set to
    one random build key; the build side unique)."""
    zipf, gen_s = _generate(*HEADLINE, seed=int(rng.integers(1, 2**31)),
                            mode="zipf", zipf=0.75)
    inner, outer = data_h
    share = float(rng.uniform(0.2, 0.5))
    hot = inner.keys[int(rng.integers(0, len(inner.keys)))]
    keys = outer.keys.copy()
    keys[rng.random(len(keys), dtype=np.float32) < share] = hot
    _print(f"phase fuzz: Zipf 0.75 {HEADLINE[0]} x {HEADLINE[1]} generated "
           f"in {gen_s:.3f} s; "
           f"heavy hitter key {int(hot)} on {share:.4f} of the probes")
    return zipf, (inner, SimpleNamespace(keys=keys, vals=outer.vals))


def _fuzz_two_class(rng, cols, final):
    """A two-class plan on these columns: the narrow window the tile span
    at a random quantile (0.5, 0.75 or 0.9) rounded up to 128 slots, so
    that the tiles past it go to the wide pass at the single-class
    window.  Fails unless it is below that window and leaves a wide
    tile."""
    span, at, window = _tile_spans(cols, final)
    q = float(rng.choice([0.5, 0.75, 0.9]))
    narrow = -(-_span_quantiles(span, [q])[0] // 128) * 128
    two, n_wide = _two_class_from(final, at, window, narrow)
    if narrow >= window or n_wide == 0:
        raise AssertionError(f"fuzz two-class: the q{q} span's window "
                             f"{narrow} against {window}, {n_wide} wide "
                             f"tiles")
    return two, (f"two-class (narrow window {narrow} from the q{q} span, "
                 f"{n_wide} wide tiles)")


def _fuzz_wide(dev, rng, plans, wide) -> list:
    """At most four draws at 16M x 256M, each with a random plan: the
    uniform relation, a two-class plan on it (no re-plan, K4 launched),
    the Zipf 0.75 relation, the heavy-hitter one.  `wide` holds the
    uniform, Zipf and heavy-hitter relations with their oracle digests
    (the last two futures on the host pool).  Returns each draw's
    (label, relations, final plan) for _fuzz_kernel_checks."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    try:
        (data_h, want_h), (zipf, want_z), (heavy, want_hv) = wide
        cols, final = _fuzz_wide_join(dev, pool, "uniform", data_h,
                                      plans[0], want_h)
        two, label = _fuzz_two_class(rng, cols, final)
        before = _launches()
        _, final2 = _fuzz_wide_join(dev, pool, label, data_h, two, want_h)
        if final2 != two or _delta(before)["merge_probe_gather_indexed"] == 0:
            raise AssertionError(f"fuzz two-class: re-planned to {final2} "
                                 f"or K4 not launched")
        del cols
        torch.cuda.empty_cache()
        _, final_z = _fuzz_wide_join(dev, pool, "Zipf 0.75", zipf, plans[1],
                                     want_z)
        torch.cuda.empty_cache()
        _, final_hv = _fuzz_wide_join(dev, pool, "heavy hitter", heavy,
                                      plans[2], want_hv)
    finally:
        pool.shutdown(wait=True)
    torch.cuda.empty_cache()
    return [("uniform", data_h, final), (label, data_h, two),
            ("Zipf 0.75", zipf, final_z), ("heavy hitter", heavy, final_hv)]


def phase_fuzz(dev, data_h, want_h) -> list:
    """The full-width draws' relations and plans first (their oracle
    digests start on a host pool), then every campaign draw on the card
    against the CPU, then the full-width joins; the phase's launch
    counts are read by the caller.  Returns the full-width draws
    (_fuzz_wide)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(FUZZ_SEED)
    plans = [_fuzz_plan(rng) for _ in range(3)]
    zipf, heavy = _fuzz_relations(rng, data_h)
    oracles = concurrent.futures.ThreadPoolExecutor(max_workers=6)
    try:
        wide = [(data_h, want_h), (zipf, _digest_chunked(zipf, oracles)),
                (heavy, _digest_chunked(heavy, oracles))]
        with tempfile.TemporaryDirectory() as tmp:
            done = _fuzz_small(dev, tmp)
        counts = {c: len(s) for c, s in done.items()}
        _print(f"phase fuzz: {sum(counts.values())} draws of "
               f"tests/torch_fuzz_cases.py equal on the card and the CPU "
               f"and to the oracle {counts} after "
               f"{time.perf_counter() - t0:.1f} s; launches {_launches()}")
        t1 = time.perf_counter()
        draws = _fuzz_wide(dev, rng, plans, wide)
    finally:
        oracles.shutdown(wait=True)
    _print(f"phase fuzz: the full-width draws in "
           f"{time.perf_counter() - t1:.1f} s; the phase "
           f"{time.perf_counter() - t0:.1f} s")
    return draws


def _fuzz_kernel_checks(dev, draws) -> dict:
    """The kernels at the shapes only the fuzz path's full-width draws
    give them, each held against its plain version on the draw's own
    relations and final plan: K1 on the probe side; the probe the plan
    dispatches (K2 or K3; on the two-class draw its narrow pass) on 256
    tiles spread over the layout; on the two-class draw, K4 on 256
    entries of its own tile list (_k4_vs_plain).  Runs after the path's
    counts are read.  Returns the largest difference per kernel."""
    from hash_join_codes_knl_tpu_torch.engine import phj
    from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    errs: dict = {}

    def held(name, label, got, want):
        _check_equal(f"{name}, fuzz {label}", got, want)
        errs[name] = max(errs.get(name, 0), _max_abs_err(got, want))

    geo = []
    for label, data, plan in draws:
        cols = _device_cols(data, dev)
        tile, window, _, cap = phj._merge_params(plan, cols[0].shape[0],
                                                 cols[2].shape[0])
        args = (cols[2], cols[3], cap, max(1, plan.probe_chunks),
                plan.factor)
        held("flat_to_rows", label, cl.flat_to_rows(*args),
             cl.flat_to_rows_torch(*args))
        if plan.window_wide:
            lay = _two_class_layout(cols, plan)
            bhk, bval, ohk, wrow = lay.bhk, lay.bval, lay.ohk, lay.wrow
            name = lay.impl
        else:
            bhk, bval, ohk, _, wrow, tile, window = _stages(cols, plan)
            name = _PROBE_NAMES[phj._merge_impl(plan, window)]
        del cols
        n_tiles = ohk.shape[0] // tile
        sel = torch.linspace(0, n_tiles - 1, 256, device=dev).long()
        sub = (ohk.view(n_tiles, tile)[sel].reshape(-1).contiguous(), bhk,
               bval, wrow[sel].contiguous(), tile, window)
        held(name, f"{label} (256 tiles)", _wrappers()[name](*sub),
             mg.merge_probe_torch(*sub))
        entries = ""
        if plan.window_wide:
            err, *_ = _k4_vs_plain(dev, lay, plan, f"fuzz {label}")
            errs["merge_probe_gather_indexed"] = max(
                errs.get("merge_probe_gather_indexed", 0), err)
            entries = (f", K4 on 256 entries of its {lay.tidx.shape[0]}-"
                       f"entry tile list")
            del lay
        geo.append(f"{label}: {name} at tile {tile}, window {window}"
                   f"{entries}")
        del bhk, bval, ohk, wrow, sub
        torch.cuda.empty_cache()
    _print(f"phase fuzz: kernels equal to their plain versions on the "
           f"full-width draws' own plans (K1 on each probe side; "
           f"{'; '.join(geo)}); max abs err {errs}")
    return errs


# --- the surface phase: the bench harness, the examples and the graft
# entry, as a user runs them

# runs a repo file as __main__ (argv: counts file, file, its arguments)
# and, at the interpreter's exit, writes every wrapper's launch count
_COUNTED = """
import atexit, importlib, json, runpy, sys
wrappers = json.loads(sys.argv[1])
counts_path = sys.argv[2]

def dump():
    counts = {}
    for name, (mod, fn) in wrappers.items():
        m = importlib.import_module("hash_join_codes_knl_tpu_torch.ops." + mod)
        counts[name] = getattr(m, fn).launches
    with open(counts_path, "w") as f:
        json.dump(counts, f)

atexit.register(dump)
sys.argv = sys.argv[3:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _start_counted(rel, args, tmp):
    """Popen of repo file `rel` with `args`, its stdout and stderr to
    files in `tmp`; its launch counts go to a file there at its exit."""
    tag = f"{os.path.basename(rel)[:-3]}_{len(os.listdir(tmp))}"
    files = {k: os.path.join(tmp, f"{tag}.{k}")
             for k in ("out", "err", "counts")}
    with open(files["out"], "w") as out, open(files["err"], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _COUNTED, json.dumps(WRAPPERS),
             files["counts"], os.path.join(REPO, rel), *args],
            cwd=REPO, stdout=out, stderr=err)
    return proc, rel, args, files


def _finish_counted(started, counts, timeout=900) -> str:
    """Wait for a _start_counted process; raise on a non-zero exit; add
    its launch counts to `counts`; return its standard output."""
    proc, rel, args, files = started
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    out = open(files["out"]).read()
    if rc != 0:
        raise AssertionError(f"{rel} {args}: exit {rc}; stdout "
                             f"{out[-2000:]!r}; stderr "
                             f"{open(files['err']).read()[-3000:]!r}")
    with open(files["counts"]) as f:
        for name, n in json.load(f).items():
            counts[name] += n
    return out


def _run_counted(rel, args, tmp, counts) -> str:
    return _finish_counted(_start_counted(rel, args, tmp), counts)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def _surface_bench(tmp, counts) -> None:
    """bench_torch.py at 16M x 256M: exact join_tuples, no error."""
    t0 = time.perf_counter()
    out = _last_json(_run_counted("bench_torch.py", [], tmp, counts))
    want = HEADLINE[1]
    if "error" in out or out["join_tuples"] != want:
        raise AssertionError(f"bench_torch.py: {out}")
    _print(f"phase surface: bench_torch.py ({time.perf_counter() - t0:.1f} "
           f"s as a process) {json.dumps(out)}")


# the matrix rows no other phase times, run at full size
FULL_ROWS = ("phj_zipf_0.75", "radix_4096", "npj_chain")


def _surface_configs(tmp, counts) -> dict:
    """scripts/torch_bench_configs.py: FULL_ROWS at full size (merged
    into one file), every row at --small; every row present, validated
    by the script and timed.  Returns the full-size rows."""
    full = os.path.join(tmp, "bench_results_torch.json")
    t0 = time.perf_counter()
    for only in FULL_ROWS:
        _run_counted("scripts/torch_bench_configs.py",
                     ["--only", only, "--out", full], tmp, counts)
    small = os.path.join(tmp, "bench_results_torch_small.json")
    _run_counted("scripts/torch_bench_configs.py",
                 ["--small", "--out", small], tmp, counts)
    rows_full, rows_small = json.load(open(full)), json.load(open(small))
    want_full = {"phj_zipf_0.75", "phj_radix_4096way", "npj_chain",
                 "npj_chain_unique"}
    if set(rows_full) != want_full or len(rows_small) != 12 or not all(
            r["seconds"] > 0 for r in [*rows_full.values(),
                                       *rows_small.values()]):
        raise AssertionError(f"bench matrix rows: {sorted(rows_full)} "
                             f"{sorted(rows_small)}")
    for label, rows in (("full size", rows_full), ("--small", rows_small)):
        for name, row in rows.items():
            _print(f"phase surface: matrix {label} {name}: "
                   f"{json.dumps(row)}")
    _print(f"phase surface: matrix rows in {time.perf_counter() - t0:.1f} s")
    return rows_full


def _surface_outofcore(tmp, counts) -> None:
    """The stream, Grace and scaling benches at 4M x 64M arguments (the
    full stream and Grace shapes run in phase_outofcore), all exact."""
    runs = (
        ("scripts/torch_bench_stream.py",
         ["--inner", "4000000", "--outer", "64000000", "--chunk",
          "16000000"]),
        ("scripts/torch_bench_grace.py",
         ["--build", "4000000", "--probe", "64000000", "--f-bits", "4",
          "--chunk", "16000000"]),
    )
    for rel, args in runs:
        out = _last_json(_run_counted(rel, args, tmp, counts))
        if out["cardinality_exact"] is not True:
            raise AssertionError(f"{rel}: {out}")
        _print(f"phase surface: {rel} {json.dumps(out)}")
    path = os.path.join(tmp, "scaling_results_torch.json")
    _run_counted("scripts/torch_bench_scaling.py",
                 ["--inner", "1000000", "--outer", "16000000", "--ranks",
                  "4", "--reps", "2", "--out", path], tmp, counts)
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples

    res = json.load(open(path))
    for m in (1, 2, 4):
        if res[str(m)]["join_tuples"] != expected_join_tuples(
                1_000_000 * m, 16_000_000 * m):
            raise AssertionError(f"scaling {m} ranks: {res[str(m)]}")
    _print(f"phase surface: scripts/torch_bench_scaling.py {json.dumps(res)}")


def _surface_examples(tmp, counts) -> None:
    """The five examples on the card, at once (none is timed)."""
    started = [_start_counted(f"examples/torch_{name}.py", args, tmp)
               for name, args in (
                   ("basic_join", []), ("dataframe_style", []),
                   ("out_of_core", [os.path.join(tmp, "spill")]),
                   ("multichip", []), ("aggregate", []))]
    for s in started:
        out = _finish_counted(s, counts)
        lines = " | ".join(out.strip().splitlines())
        _print(f"phase surface: {s[1]}: {lines}")


def _surface_graft(dev) -> None:
    """entry() on the card, equal slot for slot to the same step on the
    CPU, and dryrun_multichip(4) on four thread ranks sharing the card."""
    import __graft_entry_torch__ as graft

    from hash_join_codes_knl_tpu_torch.engine.convert import result_to_numpy

    fn, args = graft.entry()
    got = result_to_numpy(fn(*args))
    fn_c, args_c = graft.entry(device="cpu")
    want = result_to_numpy(fn_c(*args_c))
    if any(not np.array_equal(got[k], want[k]) for k in got) or int(
            got["match_cnts"].sum()) != 16384:
        raise AssertionError("entry(): the card's result differs from the "
                             "CPU's")
    t0 = time.perf_counter()
    graft.dryrun_multichip(4)
    _print(f"phase surface: entry() equal to the CPU's slot for slot "
           f"(16384 tuples); dryrun_multichip(4) exact on every step in "
           f"{time.perf_counter() - t0:.2f} s")


def _check_slots(label, res, ik, iv, ok, ov) -> None:
    """Every probe slot of a join result at full size against a plain
    searchsorted join on the card (the build keys must be unique): the
    probe rows all present (count and sums of keys and values), and each
    slot's match count and matched value."""
    def u64(t):
        return t.to(torch.int64) & 0xFFFFFFFF

    bk, order = torch.sort(u64(ik))
    if int((bk[1:] == bk[:-1]).sum()):
        raise AssertionError(f"{label}: the build keys repeat")
    pk = u64(res.probe_keys)
    live, ok_live = pk != 0, ok != 0  # key 0 is the null key
    for got, want in ((int(live.sum()), int(ok_live.sum())),
                      (int(pk.sum()), int(u64(ok).sum())),
                      (int(u64(res.probe_vals)[live].sum()),
                       int(u64(ov)[ok_live].sum()))):
        if got != want:
            raise AssertionError(f"{label}: the probe rows differ from the "
                                 f"input ({got} != {want})")
    pos = torch.searchsorted(bk, pk).clamp_(max=bk.numel() - 1)
    hit = (bk[pos] == pk) & live
    del pk, bk
    want_v = torch.where(hit, iv[order[pos]], 0)
    del order, pos
    if not (torch.equal(res.match_cnts, hit.to(torch.int32)) and torch.equal(
            torch.where(hit, res.match_vals, 0), want_v)):
        raise AssertionError(f"{label}: match counts or values differ from "
                             f"the searchsorted join")


def _radix_passes(label, hk, v, pass_bits) -> int:
    """multipass_partition's passes one by one, each kernel call held
    against its plain version on the same inputs (the kernel's output
    feeds the next pass); the largest difference."""
    from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp

    err, skip, regions = 0, 0, 1
    for b in pass_bits:
        args = (hk, v, b, skip, 0, 32768, regions)
        got, want = rp.radix_partition(*args), rp.radix_partition_torch(*args)
        _check_equal(f"radix_partition, {label} pass skip={skip}", got, want)
        if int(got[3]):
            raise AssertionError(f"{label}: radix pass overflowed")
        err = max(err, _max_abs_err(got, want))
        hk, v, regions, skip = got[0], got[1], got[2].shape[0], skip + b
    return err


def _surface_kernel_checks(dev, inner_h, rows) -> dict:
    """The kernels at the shapes only the surface path runs, on the
    matrix rows' own relations and plans, held against their plain
    versions: phj_zipf_0.75 (16M x 256M, join()'s re-planned plan, which
    must be the row's): K1 on the probe side, K3 on 256 spread tiles and
    over all tiles against K2, and every slot of the join's result
    against a searchsorted join; phj_radix_4096way (4M x 16M, (6, 6)):
    both radix passes of each side, the tile probe on 256 spread tiles
    and over its whole layout, and every slot of the join's result.
    Runs after the path's counts are read.  Returns the largest
    difference per kernel."""
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.convert import (
        relation_to_device,
    )
    from hash_join_codes_knl_tpu_torch.engine.phj import (
        _merge_params,
        _scrambled,
        join,
    )
    from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
    from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg
    from hash_join_codes_knl_tpu_torch.ops import probe as pt

    errs = {}
    (_, outer_z), _ = _generate(*HEADLINE, seed=43, mode="zipf", zipf=0.75)
    cols = (*relation_to_device(inner_h, dev),
            *relation_to_device(outer_z, dev))
    del outer_z
    res, zplan = join(*cols, plan_join(*HEADLINE, device=dev))
    row = rows["phj_zipf_0.75"]
    if (zplan.tile, zplan.window or "auto", zplan.probe_chunks) != (
            row["tile"], row["window"], row["probe_chunks"]):
        raise AssertionError(f"phj_zipf_0.75: plan {zplan} is not the "
                             f"row's {row}")
    _check_slots("phj_zipf_0.75", res, *cols)
    del res
    cap = _merge_params(zplan, *HEADLINE)[3]
    args = (cols[2], cols[3], cap, max(1, zplan.probe_chunks), zplan.factor)
    got, want = cl.flat_to_rows(*args), cl.flat_to_rows_torch(*args)
    _check_equal("flat_to_rows, phj_zipf_0.75's probe side", got, want)
    errs["flat_to_rows"] = _max_abs_err(got, want)
    del got, want
    bhk, bval, ohk, _, wrow, tile, window = _stages(cols, zplan)
    n_tiles = ohk.shape[0] // tile
    sel = torch.linspace(0, n_tiles - 1, 256, device=dev).long()
    sub = (ohk.view(n_tiles, tile)[sel].reshape(-1).contiguous(), bhk, bval,
           wrow[sel].contiguous(), tile, window)
    got, want = mg.merge_probe_gather(*sub), mg.merge_probe_torch(*sub)
    _check_equal("merge_probe_gather, phj_zipf_0.75 (256 tiles)", got, want)
    errs["merge_probe_gather"] = _max_abs_err(got, want)
    full = (ohk, bhk, bval, wrow, tile, window, max(1, zplan.probe_chunks))
    _check_equal("merge_probe_gather vs merge_probe, phj_zipf_0.75, all "
                 "tiles", mg.merge_probe_gather(*full), mp.merge_probe(*full))
    zgeo = f"tile {tile}, window {window}, {n_tiles} tiles"
    del cols, bhk, bval, ohk, wrow, sub, full, got, want
    torch.cuda.empty_cache()

    inner_r, outer_r = _generate(*RADIX_4M, seed=44, mode="uniform")[0]
    cols = (*relation_to_device(inner_r, dev),
            *relation_to_device(outer_r, dev))
    del inner_r, outer_r
    plan = _radix_4096_plan()
    res, _ = join(*cols, plan)
    _check_slots("phj_radix_4096way", res, *cols)
    del res
    errs["radix_partition"] = max(
        _radix_passes(f"phj_radix_4096way's {side} side",
                      *_scrambled(k, v, plan.factor), plan.pass_bits)
        for side, k, v in (("build", *cols[:2]), ("probe", *cols[2:])))
    lay = _padded_stages(*cols, plan)
    if int(lay["build_counts"][-1]):
        raise AssertionError("phj_radix_4096way: the layout overflowed")
    tile = 128  # radix regions take a 128-slot tile (engine/phj.py)
    pk_s, tp_s, sel = _spread_tiles(lay["pk"], lay["tpid"], tile, 256)
    sub = (pk_s, lay["tk"], lay["tv"], tp_s, tile)
    got, want = pt.probe_tiles(*sub), pt.probe_tiles_torch(*sub)
    _check_equal("probe_tiles, phj_radix_4096way (256 tiles)", got, want)
    errs["probe_tiles"] = _max_abs_err(got, want)
    _check_full_probe("probe_tiles, phj_radix_4096way, all tiles",
                      (lay["pk"], lay["tk"], lay["tv"], lay["tpid"], tile),
                      sel, want)
    _print(f"phase surface: kernels equal to their plain versions at the "
           f"matrix rows' own shapes (phj_zipf_0.75: {HEADLINE[0]} x "
           f"{HEADLINE[1]}, {zgeo}, K3 equal to K2 on all of them; "
           f"phj_radix_4096way: {RADIX_4M[0]} x {RADIX_4M[1]}, "
           f"{lay['tpid'].shape[0]} tiles of {tile}, row slots "
           f"{lay['tk'].shape[1]}); every probe slot of both rows' joins "
           f"equal to a searchsorted join; max abs err {errs}")
    return errs


def phase_surface(dev) -> tuple:
    """The repo's surface as a user runs it: bench_torch.py, the config
    matrix, the out-of-core and scaling benches, the five examples (each
    a process), entry() and dryrun_multichip(4).  Returns the launch
    counts of the processes it started (their own processes count
    them) and the matrix's full-size rows."""
    counts = dict.fromkeys(WRAPPERS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        _surface_bench(tmp, counts)
        _stamp("the surface phase's bench_torch.py")
        rows = _surface_configs(tmp, counts)
        _stamp("the surface phase's config matrix")
        _surface_outofcore(tmp, counts)
        _stamp("the surface phase's stream, Grace and scaling benches")
        _surface_examples(tmp, counts)
        _stamp("the surface phase's examples")
    _surface_graft(dev)
    _stamp("the surface phase's graft entry")
    return counts, rows


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
    # no pallas_call: the JAX merge path's unscramble, a uint32 multiply
    # XLA fused
    ("mul_u32", "hash_join_codes_knl_tpu_torch/csrc/scramble.cu",
     "hash_join_codes_knl_tpu/engine/phj.py:539"),
]
# the kernels each path must launch (NPJ hashes with range_hash, which
# keeps the int64 multiply: no unscramble there)
MERGE_KERNELS = ["flat_to_rows", "merge_probe", "merge_probe_gather",
                 "merge_probe_gather_indexed", "mul_u32"]
PADDED_KERNELS = ["flat_to_rows", "probe_tiles", "radix_partition",
                  "mul_u32"]
NPJ_KERNELS = ["merge_probe"]
CLI_KERNELS = ["flat_to_rows", "merge_probe", "merge_probe_gather",
               "mul_u32"]
OUTOFCORE_KERNELS = ["flat_to_rows", "merge_probe_gather", "radix_partition",
                     "mul_u32"]
DIST_KERNELS = ["flat_to_rows", "merge_probe", "merge_probe_gather",
                "probe_tiles", "radix_partition", "mul_u32"]
# K4 runs only on a two-class plan, which no surface entry point makes
SURFACE_KERNELS = DIST_KERNELS
FUZZ_KERNELS = [name for name, _, _ in KERNELS]


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
    # the plan-time tuner's verdicts go to a fresh cache file, read by
    # every plan of this run (the headline's included)
    tune_dir = tempfile.mkdtemp()
    os.environ["HJK_TUNE_CACHE"] = os.path.join(tune_dir, "tune.json")
    try:
        _main_paths(dev)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _main_paths(dev) -> None:
    """Every path's runs, the launch counts and the kernels line."""
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join

    # the host relations stay for the distributed phase
    data_h, gen_s = _generate(*HEADLINE, seed=42, mode="uniform")
    cols_h = _device_cols(data_h, dev)
    data_1m, _ = _generate(*SMALL, seed=41, mode="uniform")
    _stamp("the build and the generation of 16M x 256M and 1M x 8M")
    phase_tuner(cols_h)
    _stamp("the tuner")
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
    # the out-of-core phase's resume check and the distributed phase join
    # the same relations
    want_4m = oracles["uniform_4m"][1]
    want_z4m = oracles["zipf_4m"][1]
    phase_joins(dev, oracles)
    concurrent.futures.wait([digest for _, digest in oracles.values()])
    _stamp("the merge path's digests")
    head_med = phase_headline(dev, cols_h, gen_s)
    _stamp("the merge headline")
    torch.cuda.empty_cache()
    zipf_h, cols_z, plan_z, want_z = phase_zipf_headline(dev)
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
    torch.cuda.empty_cache()

    _set_launches()
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli_files(tmp)
        _stamp("the CLI's 1M x 8M runs")
        phase_cli_headline(tmp, cols_h)
        _stamp("the CLI's headline run")
    cli = _launches()
    _print(f"launches, cli path: {cli}")
    torch.cuda.empty_cache()
    phase_aggregates(cols_h)
    _stamp("the aggregate timings")
    del cols_h
    torch.cuda.empty_cache()

    _set_launches()
    phase_outofcore(dev, want_4m)
    outofcore = _launches()
    _print(f"launches, out-of-core path: {outofcore}")
    torch.cuda.empty_cache()

    uni_4m, _ = _generate(*HEADLINE_4M, seed=42, mode="uniform")
    zipf_4m, _ = _generate(*HEADLINE_4M, seed=43, mode="zipf", zipf=1.0)
    _set_launches()
    inputs = phase_distributed(dev, head_med, data_h, zipf_h,
                               want_4m.result(), want_z4m.result(), uni_4m,
                               zipf_4m)
    distributed = _launches()
    _print(f"launches, distributed path: {distributed}")
    inner_h = data_h[0]  # the matrix rows' build side
    want_h = inputs.pop("want_h")
    del uni_4m, zipf_4m, zipf_h
    torch.cuda.empty_cache()
    for name, err in _dist_kernel_checks(inputs.pop("meshes"),
                                         inputs).items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    _stamp("the distributed kernel checks")
    torch.cuda.empty_cache()

    _set_launches()
    draws = phase_fuzz(dev, data_h, want_h)
    fuzz = _launches()
    _print(f"launches, fuzz path: {fuzz}")
    _stamp("the fuzz phase")
    torch.cuda.empty_cache()
    for name, err in _fuzz_kernel_checks(dev, draws).items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    del data_h, draws
    _stamp("the fuzz kernel checks")
    torch.cuda.empty_cache()

    _set_launches()
    by_processes, rows = phase_surface(dev)
    surface = {k: n + by_processes[k] for k, n in _launches().items()}
    _print(f"launches, surface path: {surface}")
    torch.cuda.empty_cache()
    for name, err in _surface_kernel_checks(dev, inner_h, rows).items():
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    del inner_h
    _stamp("the surface kernel checks")
    for path, names, got in (("merge", MERGE_KERNELS, merge),
                             ("padded", PADDED_KERNELS, padded),
                             ("npj", NPJ_KERNELS, npj),
                             ("cli", CLI_KERNELS, cli),
                             ("out-of-core", OUTOFCORE_KERNELS, outofcore),
                             ("distributed", DIST_KERNELS, distributed),
                             ("surface", SURFACE_KERNELS, surface),
                             ("fuzz", FUZZ_KERNELS, fuzz)):
        for name in names:
            if got[name] == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{path} path")

    # no single PyTorch call computes any of these kernels' functions
    # (PERF.md says why, kernel by kernel; torch has no uint32 multiply),
    # so library_ms is null
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=(merge[name] + padded[name] + npj[name]
                              + cli[name] + outofcore[name]
                              + distributed[name] + surface[name]
                              + fuzz[name]),
                    library_ms=None, **stats[name])
               for name, src, rep in KERNELS]
    _print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    sys.exit(main())
