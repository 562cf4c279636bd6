"""K2: the dense window probe, and the plain probe every window probe
shares (K2, K3 and K4).

Counterpart of ``hash_join_codes_knl_tpu/ops/merge_probe_pallas.py``
(``merge_probe_pallas``: ``window_probe_call`` with
``_dense_row_result_factory``; plain version ``merge_probe_jnp``).

Contract of the window probes (this one and ``merge_probe_gather``):
probe tile t (slots [t*tile, (t+1)*tile) of the flat probe column) is
compared with the build slots [wrow[t]*128, wrow[t]*128 + window), the
start clamped into the build side as the JAX oracle's dynamic_slice
clamps it.  Each probe gets the count of equal build slots and the
maximum matched value (unsigned), or 0.  Keys are biased int32
(utils/hashing.py); the null key never matches, on either side.  The
dense probe does not need a sorted window.  ``chunks`` (the probe
column's independently sorted runs of tiles, ``plan.probe_chunks``) only
orders the kernels' blocks (``block_tiles``); no result depends on it.

Kernel: ``csrc/merge_probe.cu``.  Bound on the H100: bytes (the probes
and anchors read once, the union of the tiles' windows read once, both
outputs written once).  The TPU kernel's all-pairs sweep does tile x
window compares a tile; the function needs one lookup a probe.  So a
block builds the tile probe's shared-memory hash table
(``csrc/smem_table.cuh``) of a window and every probe of the tiles that
share that window start looks its key up once.  A round of the table
holds at most ``stage`` live slots and wider windows take more rounds
(counts add, maxes combine); ``window_table_geometry`` sizes them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.hashing import BIAS
from . import _build
from .probe import ENTRY_BYTES, MAX_STAGE, MIN_STAGE

_U32_MASK = 0xFFFFFFFF
# bound on the plain version's (tiles x tile x window) compare block
_PLAIN_BLOCK_ELEMS = 1 << 25
# probe slots one block of K2 takes (whole tiles of one chunk, at least
# one tile): tiles with a common window start then share one table
BLOCK_PROBES = 8192


class WindowTable(NamedTuple):
    """K2's launch geometry (``window_table_geometry``)."""

    stage: int  # live window slots one round of the table holds
    entries: int  # table entries, a power of two >= 2 * stage
    smem: int  # dynamic shared-memory bytes of the table
    threads: int  # threads a block; a chunk of 4 slots a thread fits a round
    tiles_per_block: int
    rounds: int  # rounds of a window with every slot live


def window_table_geometry(window: int, tile: int,
                          n_tiles: int) -> WindowTable:
    """K2's table and launch for `window`-slot windows and n_tiles tiles
    of `tile` probes: the tile probe's rule (ops/probe.py
    ``table_geometry``) with the window as the row.  ``stage`` is the
    window rounded up to a power of two within [MIN_STAGE, MAX_STAGE];
    the table has twice as many entries, so a walk always meets an empty
    one.  A block takes BLOCK_PROBES // tile tiles (at least one)."""
    if min(window, tile) < 1 or n_tiles < 0:
        raise ValueError(f"window={window}, tile={tile}, n_tiles={n_tiles} "
                         "must be positive")
    stage = min(MAX_STAGE, max(MIN_STAGE, 1 << (window - 1).bit_length()))
    entries = 2 * stage
    threads = min(1024, stage // 4)
    tiles_per_block = max(1, min(n_tiles, BLOCK_PROBES // tile))
    return WindowTable(stage, entries, ENTRY_BYTES * entries, threads,
                       tiles_per_block, -(-window // stage))


def block_tiles(n_tiles: int, chunks: int, tiles_per_block: int):
    """(first, end) tile of every block of the window probes' grid, as
    int64 tensors: csrc/hjk.cuh ``block_tiles``.  Block b takes chunk b %
    chunks (a chunk is ceil(n_tiles / chunks) tiles, the last ones may be
    short or empty) and in it the (b // chunks)-th run of
    tiles_per_block tiles, so tiles at one position of every chunk run
    together."""
    per_chunk = -(-n_tiles // chunks)
    b = torch.arange(chunks * -(-per_chunk // tiles_per_block))
    c = b % chunks
    first = c * per_chunk + (b // chunks) * tiles_per_block
    end = torch.minimum(first + tiles_per_block,
                        ((c + 1) * per_chunk).clamp(max=n_tiles))
    return first, torch.maximum(end, first)


def check_probe_args(probe_hk, build_hk, build_val, wrow, tile: int,
                     window: int, tile_idx=None) -> None:
    """Validate the window probes' inputs (shared by K2, K3 and K4; K4
    passes its tile list, and `wrow` then holds one anchor per entry)."""
    cols = [("probe_hk", probe_hk), ("build_hk", build_hk),
            ("build_val", build_val), ("wrow", wrow)]
    if tile_idx is not None:
        cols.append(("tile_idx", tile_idx))
    for name, t in cols:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
        if t.device != probe_hk.device:
            raise ValueError(f"{name} is on {t.device}, probe on "
                             f"{probe_hk.device}")
    if tile <= 0 or probe_hk.shape[0] % tile:
        raise ValueError(f"probe length {probe_hk.shape[0]} is not a "
                         f"multiple of tile {tile}")
    anchors = (probe_hk.shape[0] // tile if tile_idx is None
               else tile_idx.shape[0])
    if wrow.shape[0] != anchors:
        raise ValueError("wrow needs one anchor row per probed tile")
    if window <= 0 or window % 128 or window > build_hk.shape[0]:
        raise ValueError(f"window {window} must be a positive multiple of "
                         f"128 no wider than the build side")
    if build_val.shape != build_hk.shape:
        raise ValueError("build_hk and build_val must share one shape")


def merge_probe_torch(probe_hk, build_hk, build_val, wrow, tile: int,
                      window: int, chunks: int = 1):
    """Plain version of the window probes: every probe of a tile
    against every slot of its window, in blocks of tiles.  `chunks`
    orders only the kernels' blocks, and is not used here."""
    check_probe_args(probe_hk, build_hk, build_val, wrow, tile, window)
    n_tiles = probe_hk.shape[0] // tile
    dev = probe_hk.device
    start = (wrow.to(torch.int64) * 128).clamp(
        max=build_hk.shape[0] - window).clamp(min=0)
    offs = torch.arange(window, device=dev)
    mv = torch.empty_like(probe_hk)
    mc = torch.empty_like(probe_hk)
    ok_all = probe_hk.view(n_tiles, tile)
    step = max(1, _PLAIN_BLOCK_ELEMS // (tile * window))
    for t0 in range(0, n_tiles, step):
        t1 = min(n_tiles, t0 + step)
        idx = start[t0:t1, None] + offs  # (b, window)
        wk = build_hk[idx]
        wv = build_val[idx].to(torch.int64) & _U32_MASK
        ok = ok_all[t0:t1]
        eq = ((ok[:, :, None] == wk[:, None, :])
              & (ok != BIAS)[:, :, None] & (wk != BIAS)[:, None, :])
        mc.view(n_tiles, tile)[t0:t1] = eq.sum(-1, dtype=torch.int32)
        best = torch.where(eq, wv[:, None, :], 0).amax(-1)
        mv.view(n_tiles, tile)[t0:t1] = best.to(torch.int32)
    return mv, mc


def merge_probe(probe_hk, build_hk, build_val, wrow, tile: int,
                window: int, chunks: int = 1):
    """Dense window probe: (match_vals, match_cnts), int32 columns in the
    probe's (cap,) layout.  A CUDA tensor launches K2; a CPU tensor takes
    the plain version."""
    if probe_hk.device.type == "cpu":
        return merge_probe_torch(probe_hk, build_hk, build_val, wrow, tile,
                                 window)
    check_probe_args(probe_hk, build_hk, build_val, wrow, tile, window)
    mv = torch.empty_like(probe_hk)
    mc = torch.empty_like(probe_hk)
    n_tiles = probe_hk.shape[0] // tile
    geo = window_table_geometry(window, tile, n_tiles)
    _build.launch("hjk_merge_probe_dense", probe_hk.device, probe_hk,
                  probe_hk.shape[0], build_hk, build_val, build_hk.shape[0],
                  wrow, tile, window, mv, mc, max(1, chunks), geo.stage,
                  geo.entries, geo.threads, geo.tiles_per_block)
    _build.count_launch(merge_probe)
    return mv, mc


merge_probe.launches = 0
