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
dense sweep does not need a sorted window.

Kernel: ``csrc/merge_probe.cu``.  Bound on the H100: compares, tile x
window per tile.  One block per tile stages the window through shared
memory and every thread keeps eight probes and their accumulators in
registers, so each staged slot is one broadcast read per eight compares.
"""

from __future__ import annotations

import torch

from ..utils.hashing import BIAS
from . import _build

_U32_MASK = 0xFFFFFFFF
# bound on the plain version's (tiles x tile x window) compare block
_PLAIN_BLOCK_ELEMS = 1 << 25


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
                      window: int):
    """Plain version of the window probes: every probe of a tile
    against every slot of its window, in blocks of tiles."""
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
                window: int):
    """Dense window probe: (match_vals, match_cnts), int32 columns in the
    probe's (cap,) layout.  A CUDA tensor launches K2; a CPU tensor takes
    the plain version."""
    if probe_hk.device.type == "cpu":
        return merge_probe_torch(probe_hk, build_hk, build_val, wrow, tile,
                                 window)
    check_probe_args(probe_hk, build_hk, build_val, wrow, tile, window)
    mv = torch.empty_like(probe_hk)
    mc = torch.empty_like(probe_hk)
    _build.launch("hjk_merge_probe_dense", probe_hk.device, probe_hk,
                  probe_hk.shape[0], build_hk, build_val, build_hk.shape[0],
                  wrow, tile, window, mv, mc)
    merge_probe.launches += 1
    return mv, mc


merge_probe.launches = 0
