"""The tile probe of the padded PHJ: each probe tile against the dense
table row of its partition.

Counterpart of ``hash_join_codes_knl_tpu/ops/probe_pallas.py``
(``probe_tiles_pallas``, body ``_probe_kernel``) and of its plain
version ``probe_tiles_jnp`` (``ops/probe.py`` there).

Contract: probe tile t covers slots [t*tile, (t+1)*tile) of the padded
layout and is compared with every slot of table row tile_pid[t]
(tile_pid is non-decreasing, every value in [0, P)).  Each probe gets
the count of equal table slots and the unsigned maximum of their values,
or 0.  Keys are biased (utils/hashing.py); the null key never matches,
on either side.  The kernel, like the TPU kernel, takes no table counts:
table slots past a partition's fill hold the null key, so the plain
version's ``table_counts`` mask changes nothing there.

Kernel: ``csrc/probe_tiles.cu``.  Bound on the H100: bytes (probes,
tile ids and the rows used read once, both outputs written once); the
function needs one lookup per probe, not a compare per table slot.  One
block takes a run of consecutive tiles; for each partition the run
touches it builds an open-addressing hash table of the row in shared
memory, entries (key, count, max value), and each probe walks from the
mixed key's index to its key or to an empty entry.  A round of the table
holds at most ``stage`` live slots; a row with more takes more rounds,
whose counts add and whose maxes combine.  ``table_geometry`` sizes the
rounds, the table and the launch here, where the CPU tests reach it;
``table_index`` mirrors the kernel's mix of a key.
"""

from __future__ import annotations

import torch

from ..utils.hashing import BIAS, bias
from . import _build
from ._build import SMEM_LIMIT

# bound on the plain version's (tiles x tile x slots) compare block
_PLAIN_BLOCK_ELEMS = 1 << 25

ENTRY_BYTES = 12  # key, count, max value
MIN_STAGE, MAX_STAGE = 512, 8192
assert 2 * MAX_STAGE * ENTRY_BYTES <= SMEM_LIMIT  # the largest table fits
# most probe slots one block takes: a partition's tiles go to one block
# while they fit (its row is then built once), else to equal shares
MAX_BLOCK_PROBES = 1 << 17


def table_geometry(slots: int, tile: int, n_tiles: int,
                   partitions: int) -> tuple[int, int, int, int, int]:
    """(stage, entries, shared-memory bytes, threads, tiles per block) of
    the kernel for (partitions, slots) tables and n_tiles probe tiles.
    `stage`, the live slots one round of the table may hold, is `slots`
    rounded up to a power of two within [MIN_STAGE, MAX_STAGE]; the table
    has twice as many entries, so a walk always meets an empty one; a
    thread reads four row slots per chunk, and one chunk must fit a round.
    A block takes the mean number of tiles of a partition (the radix
    layout's regions are equal, so there a block is a partition and every
    row is built once), cut into equal shares past MAX_BLOCK_PROBES."""
    if min(slots, tile, partitions) < 1 or n_tiles < 0:
        raise ValueError(f"slots={slots}, tile={tile}, n_tiles={n_tiles}, "
                         f"partitions={partitions} must be positive")
    stage = min(MAX_STAGE, max(MIN_STAGE, 1 << (slots - 1).bit_length()))
    entries = 2 * stage
    threads = min(1024, stage // 4)
    per_partition = max(1, -(-n_tiles // partitions))
    shares = -(-per_partition * tile // MAX_BLOCK_PROBES)
    return (stage, entries, ENTRY_BYTES * entries, threads,
            -(-per_partition // shares))


def table_index(keys: torch.Tensor, entries: int) -> torch.Tensor:
    """First table index of each biased key (int64): the kernel's mix
    (murmur3's 32-bit finalizer) of the key's bits, modulo `entries`.  A
    row's keys share their top bits, so the index must not be those."""
    m = 0xFFFFFFFF
    x = keys.to(torch.int64) & m
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & m
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & m
    return (x ^ (x >> 16)) & (entries - 1)


def _check(probe_keys, table_keys, table_vals, tile_pid, tile: int) -> None:
    for name, t in (("probe_keys", probe_keys), ("table_keys", table_keys),
                    ("table_vals", table_vals), ("tile_pid", tile_pid)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
        if t.device != probe_keys.device:
            raise ValueError(f"{name} is on {t.device}, probe on "
                             f"{probe_keys.device}")
    if probe_keys.dim() != 1 or tile_pid.dim() != 1:
        raise ValueError("probe_keys and tile_pid must be 1-D")
    if table_keys.dim() != 2 or table_vals.shape != table_keys.shape:
        raise ValueError("table_keys and table_vals must share one (P, S) "
                         "shape")
    if tile <= 0 or probe_keys.shape[0] % tile:
        raise ValueError(f"probe length {probe_keys.shape[0]} is not a "
                         f"multiple of tile {tile}")
    if tile_pid.shape[0] != probe_keys.shape[0] // tile:
        raise ValueError("tile_pid needs one partition per probe tile")


def probe_tiles_torch(probe_keys, table_keys, table_vals, tile_pid,
                      tile: int, table_counts=None):
    """Plain version: every probe of a tile against every slot of its
    table row, in blocks of tiles.  With `table_counts`, slots at or past
    a row's count are masked out, as ``probe_tiles_jnp`` masks them.
    Returns (match_vals, match_cnts), int32 columns in the probe layout."""
    _check(probe_keys, table_keys, table_vals, tile_pid, tile)
    n_tiles = tile_pid.shape[0]
    slots = table_keys.shape[1]
    mv = torch.empty_like(probe_keys)
    mc = torch.empty_like(probe_keys)
    probe2d = probe_keys.view(n_tiles, tile)
    col = torch.arange(slots, device=probe_keys.device)
    step = max(1, _PLAIN_BLOCK_ELEMS // (tile * max(slots, 1)))
    for t0 in range(0, n_tiles, step):
        t1 = min(n_tiles, t0 + step)
        pids = tile_pid[t0:t1].long()
        tk = table_keys[pids]  # (b, S)
        live = tk != BIAS
        if table_counts is not None:
            live &= col < table_counts[pids, None]
        ok = probe2d[t0:t1]
        eq = (ok[:, :, None] == tk[:, None, :]) & live[:, None, :]
        mc.view(n_tiles, tile)[t0:t1] = eq.sum(-1, dtype=torch.int32)
        # unsigned max as a signed max of biased values; no match gives
        # bias(BIAS) == 0
        best = torch.where(eq, bias(table_vals[pids])[:, None, :], BIAS)
        mv.view(n_tiles, tile)[t0:t1] = bias(best.amax(-1))
    return mv, mc


def probe_tiles(probe_keys, table_keys, table_vals, tile_pid, tile: int):
    """Tile probe: (match_vals, match_cnts), int32 columns in the probe's
    padded layout.  A CUDA tensor launches the kernel; a CPU tensor takes
    the plain version."""
    if probe_keys.device.type == "cpu":
        return probe_tiles_torch(probe_keys, table_keys, table_vals,
                                 tile_pid, tile)
    _check(probe_keys, table_keys, table_vals, tile_pid, tile)
    mv = torch.empty_like(probe_keys)
    mc = torch.empty_like(probe_keys)
    slots = table_keys.shape[1]
    stage, entries, _, threads, tiles_per_block = table_geometry(
        slots, tile, tile_pid.shape[0], table_keys.shape[0])
    _build.launch("hjk_probe_tiles", probe_keys.device, probe_keys,
                  tile_pid.shape[0], tile, table_keys, table_vals, slots,
                  tile_pid, mv, mc, stage, entries, threads, tiles_per_block)
    _build.count_launch(probe_tiles)
    return mv, mc


probe_tiles.launches = 0
