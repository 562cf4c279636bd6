"""K3, the wide-window probe, and K4, its indexed pass: searches in a
window staged in shared memory.

Counterpart of ``hash_join_codes_knl_tpu/ops/merge_probe_gather.py``
(``merge_probe_gather``: ``window_probe_call`` with
``_gather_row_result_factory``).  Same contract as the dense probe
(ops/merge_probe.py), plus one precondition: the build side is sorted by
(key, value).  The TPU kernel selected two 128-slot chunks by their
boundaries, gathered them across lanes and counted the run from chunk
arithmetic, all to avoid a gather it did not have.  Here a probe's
matches are the run [lo, hi) of its key in the sorted window: count =
hi - lo, and since equal-key runs are value-ascending the maximum
matched value is val[hi - 1].  Both are exact for any M:N run inside the
window, and the window-overflow statistic guarantees that every run a
probe can match lies inside it.  The select overflow of the TPU kernel's
opportunistic selects has no counterpart: this kernel has one exact
select.

Kernel: ``csrc/merge_probe_gather.cu``, one body for K3 and K4.  Bound on
the H100: bytes (the probes, the union of the windows' keys, one value
per matched probe, both outputs).  A search chain of about log2(window)
dependent loads from device memory would cost far more, so a block
serves one tile and stages its window's keys in shared memory
(``gather_geometry``: the gather band's widest window, 121 chunks, is one
62 KB piece), searches both bounds there and reads only val[hi - 1] from
device memory.  The probes need not be sorted within a tile: the result
is exact either way, sorted probes only search faster.

K3, ``merge_probe_gather``, probes every tile.  Its blocks go position by
position over the probe's ``chunks`` sorted runs of tiles
(``merge_probe.block_tiles``), so the 64 tiles of the headline plan that
share a build range stage it from L2.  Its plain version is the dense
sweep's, ``merge_probe_torch``: the JAX package checks both kernels
against one oracle too.

K4, ``merge_probe_gather_indexed``, is the two-class window geometry's
wide pass (``window_probe_call_indexed`` via
``merge_probe_gather_indexed`` in the JAX package): the same search over
a compact list of tiles at the wide width, one block per list entry,
written in place onto the first pass's outputs.  Its blocks go position
by position over ``chunks`` runs of the list (``block_entries``), so for
the engine's ascending lists the entries of one chunk position run
together, as K3's tiles do.  Its window is one staged piece (at most
MAX_PIECE keys, the JAX wrapper's limit of 128 chunks), so every listed
slot takes one plain store.  Its plain version gathers the listed tiles,
runs ``merge_probe_torch`` on them and writes the results back.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import SMEM_LIMIT
from .merge_probe import check_probe_args, merge_probe_torch

__all__ = ["block_entries", "gather_geometry", "merge_probe_gather",
           "merge_probe_gather_indexed", "merge_probe_gather_indexed_torch",
           "merge_probe_torch"]

# most window keys K3 and K4 stage at a time (64 KB): the gather band's
# widest window (121 chunks, 15,488 keys) is one piece, three blocks fit
# an SM's shared memory, and K4 takes no wider window.  Threads a block:
# 256 searched the headline's tiles in 2.47 ms against 2.63 (512) and 3.06
# (1024) on one H100 (PERF.md, scripts/torch_sweep_window_probes.py)
MAX_PIECE = 16384
MAX_THREADS = 256
assert 4 * MAX_PIECE <= SMEM_LIMIT


def gather_geometry(window: int, tile: int) -> tuple[int, int, int]:
    """(piece, shared-memory bytes, threads) of K3 and K4 for
    `window`-slot windows and `tile`-probe tiles: the window is staged in
    pieces of at most MAX_PIECE keys (a multiple of 128, like the window),
    and a block has MAX_THREADS threads, or fewer for a tile of fewer
    probes."""
    if window < 128 or window % 128 or tile < 1:
        raise ValueError(f"window={window} must be a positive multiple of "
                         f"128 and tile={tile} positive")
    piece = min(window, MAX_PIECE)
    threads = min(MAX_THREADS, -(-tile // 32) * 32)
    return piece, 4 * piece, threads


def block_entries(n_idx: int, chunks: int):
    """List entry of every block of K4's grid, -1 for a block with none
    (csrc/hjk.cuh ``block_entry``): the n_idx entries split into `chunks`
    runs, run c = [ceil(c * n_idx / chunks), ceil((c + 1) * n_idx /
    chunks)); block b takes run b % chunks, entry b // chunks of it."""
    b = torch.arange(chunks * -(-n_idx // chunks))
    c = b % chunks
    j = -(-c * n_idx // chunks) + b // chunks
    return torch.where(j < -(-(c + 1) * n_idx // chunks), j, -1)


def merge_probe_gather(probe_hk, build_hk, build_val, wrow, tile: int,
                       window: int, chunks: int = 1):
    """Wide-window probe: (match_vals, match_cnts), int32 columns in the
    probe's (cap,) layout.  Needs the build side sorted by (key, value).
    `chunks` (the probe's sorted runs of tiles) orders the kernel's
    blocks only.  A CUDA tensor launches K3; a CPU tensor takes the plain
    version."""
    if probe_hk.device.type == "cpu":
        return merge_probe_torch(probe_hk, build_hk, build_val, wrow, tile,
                                 window)
    check_probe_args(probe_hk, build_hk, build_val, wrow, tile, window)
    mv = torch.empty_like(probe_hk)
    mc = torch.empty_like(probe_hk)
    piece, _, threads = gather_geometry(window, tile)
    _build.launch("hjk_merge_probe_gather", probe_hk.device, probe_hk,
                  probe_hk.shape[0], build_hk, build_val, build_hk.shape[0],
                  wrow, tile, window, mv, mc, max(1, chunks), piece, threads)
    merge_probe_gather.launches += 1
    return mv, mc


merge_probe_gather.launches = 0


def _check_indexed_args(probe_hk, build_hk, build_val, wrow_compact,
                        tile_idx, mv, mc, tile: int, window: int) -> None:
    check_probe_args(probe_hk, build_hk, build_val, wrow_compact, tile,
                     window, tile_idx)
    if window > MAX_PIECE:
        # the JAX wrapper's limit (window // 128 <= 128): K4 stages its
        # window in one piece and stores each listed slot once
        raise ValueError(f"window {window} of the indexed pass is wider "
                         f"than {MAX_PIECE} slots")
    for name, t in (("mv", mv), ("mc", mc)):
        if (t.dtype != torch.int32 or t.shape != probe_hk.shape
                or not t.is_contiguous() or t.device != probe_hk.device):
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             "shaped and placed like the probe column")


def merge_probe_gather_indexed_torch(probe_hk, build_hk, build_val,
                                     wrow_compact, tile_idx, mv, mc,
                                     tile: int, window: int):
    """Plain version of K4: the listed tiles through merge_probe_torch,
    their results written into (mv, mc) in place; entries outside [0,
    tiles) are skipped, and a window wider than MAX_PIECE slots is
    refused, as K4 refuses it.  Returns (mv, mc)."""
    _check_indexed_args(probe_hk, build_hk, build_val, wrow_compact,
                        tile_idx, mv, mc, tile, window)
    n_tiles = probe_hk.shape[0] // tile
    idx = tile_idx.long()
    listed = (idx >= 0) & (idx < n_tiles)  # K4 skips any other entry
    idx, wrow_compact = idx[listed], wrow_compact[listed]
    sub = probe_hk.view(n_tiles, tile)[idx].reshape(-1)
    smv, smc = merge_probe_torch(sub, build_hk, build_val, wrow_compact,
                                 tile, window)
    mv.view(n_tiles, tile)[idx] = smv.view(-1, tile)
    mc.view(n_tiles, tile)[idx] = smc.view(-1, tile)
    return mv, mc


def merge_probe_gather_indexed(probe_hk, build_hk, build_val, wrow_compact,
                               tile_idx, mv, mc, tile: int, window: int,
                               chunks: int = 1):
    """The wide pass over a compact tile list: tile tile_idx[j] of the
    probe column is probed at `window` from anchor row wrow_compact[j]
    (already clamped for this width), with K3's contract, and its slots
    of (mv, mc) are overwritten IN PLACE; every other slot keeps the
    first pass's value.  The JAX package aliases the outputs to these
    inputs instead; the engine passes the narrow pass's fresh outputs, so
    nothing else sees the write.  An entry outside [0, tiles) is skipped
    and writes nothing (the engine's list is a prefix of a permutation of
    the tiles); an entry may repeat a tile with the same anchor.  A
    window wider than MAX_PIECE slots is refused.  `chunks` (the probe's
    sorted runs of tiles) orders the kernel's blocks only.  A CUDA tensor
    launches K4; a CPU tensor takes the plain version.  Returns (mv,
    mc)."""
    if probe_hk.device.type == "cpu":
        return merge_probe_gather_indexed_torch(
            probe_hk, build_hk, build_val, wrow_compact, tile_idx, mv, mc,
            tile, window)
    _check_indexed_args(probe_hk, build_hk, build_val, wrow_compact,
                        tile_idx, mv, mc, tile, window)
    if tile_idx.numel() == 0:
        return mv, mc
    piece, _, threads = gather_geometry(window, tile)
    _build.launch("hjk_merge_probe_gather_indexed", probe_hk.device,
                  probe_hk, probe_hk.shape[0], build_hk, build_val,
                  build_hk.shape[0], wrow_compact, tile_idx,
                  tile_idx.shape[0], tile, window, mv, mc, max(1, chunks),
                  piece, threads)
    merge_probe_gather_indexed.launches += 1
    return mv, mc


merge_probe_gather_indexed.launches = 0
