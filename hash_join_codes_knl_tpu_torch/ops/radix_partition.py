"""One radix-partition pass, and passes composed into a full partitioning.

Counterpart of ``hash_join_codes_knl_tpu/ops/radix_partition_pallas.py``
(``radix_partition_pallas``, body ``_scatter_kernel``; pass loop
``multipass_partition``).  A pass routes each tuple by hash bits
[31-skip, 31-skip-bits] into F = 2^bits partition-contiguous regions of
`cap` slots.  The input is cut into tiles; a (n_tiles, F) histogram and
an exclusive scan over tiles give each (tile, partition) run its
destination row; region p then holds, in tile order, each tile's run of
partition p, every run starting on a 128-slot row and followed by the
null key up to the next run.  Null keys are dropped; counts are exact.

Geometry, counts, destinations and the overflow rule are the JAX
function's, one to one, so output shapes and overflow agree.  ``mrr``
(the largest run, in rows) is the TPU kernel's VMEM staging bound: the
H100 kernel stages sub-chunks, not runs, and the bound is kept only so
that overflow agrees with the reference.  Within a run the port keeps input order (a
stable scatter), where the TPU kernel sorts each tile first; against the
JAX function the runs agree as (key, value) multisets, against the plain
version here slot for slot.

Keys are biased (utils/hashing.py): pads are the biased null key
``BIAS`` with value 0, where the JAX package pads with key 0.

Kernel: ``csrc/radix_partition.cu`` (a per-tile histogram, then a stable
scatter into outputs prefilled with the null key).  Bound on the H100:
memory traffic.  The histogram runs at the memory rate; the scatter is
where the time goes, so a block regroups each sub-chunk of its tile by
partition in shared memory (a stable rank per tuple, a running offset
per partition carried from sub-chunk to sub-chunk) and writes every run
with neighbouring threads on neighbouring slots.  ``scatter_geometry``
sizes the block and its shared memory here, where the CPU tests reach
it.  The scan between the two launches is plain torch.
"""

from __future__ import annotations

import torch

from ..utils.hashing import BIAS, unbias
from . import _build
from ._build import SMEM_LIMIT

MAX_BITS = 12  # the histogram kernel's shared array holds 4096 counters
SCATTER_THREADS = 512  # the scatter's block, where shared memory allows
SUBCHUNK_PER_THREAD = 8  # tuples a thread ranks per sub-chunk (kPerLane)


def scatter_geometry(bits: int) -> tuple[int, int, int]:
    """(threads, sub-chunk tuples, shared-memory bytes) of the scatter
    kernel at fanout 2^bits: the largest block up to SCATTER_THREADS whose
    staging area (keys and values of one sub-chunk), per-warp counters
    (one padded column per warp) and four per-partition arrays fit one
    block's shared memory."""
    F = 1 << bits
    threads = SCATTER_THREADS
    while True:
        sub = threads * SUBCHUNK_PER_THREAD
        smem = 4 * (2 * sub + F * (threads // 32 + 1) + 4 * F)
        if smem <= SMEM_LIMIT:
            return threads, sub, smem
        threads //= 2


def _check(hk, vals, bits: int, skip_bits: int, tile: int,
           regions: int) -> None:
    for name, t in (("hk", hk), ("vals", vals)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if hk.shape != vals.shape or hk.device != vals.device:
        raise ValueError("hk and vals must share shape and device")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits={bits}: one pass takes 1 to {MAX_BITS} bits "
                         f"(the kernel's histogram holds 2^{MAX_BITS} "
                         "partitions); split the fanout into passes")
    if not 0 <= skip_bits <= 31:
        raise ValueError(f"skip_bits={skip_bits} must lie in [0, 31]")
    if tile <= 0 or tile % 128:
        raise ValueError(f"tile={tile} must be a positive multiple of 128")
    if regions < 1 or hk.shape[0] % regions:
        raise ValueError(f"{hk.shape[0]} slots do not split into {regions} "
                         "equal regions")


def geometry(n: int, bits: int, cap: int = 0, tile: int = 32768):
    """The JAX function's static geometry for n input slots: (tile,
    n_tiles, mrr, cap).  The tile is clamped to the input; cap == 0 is
    the mean plus a Poisson tail plus a row of round-up per tile; every
    cap gets mrr rows of slack."""
    F = 1 << bits
    tile = min(tile, max(128 * F, -(-n // 128) * 128))
    n_tiles = -(-n // tile)
    mrr = min(tile // 128, int((4 * (tile / F)) // 128) + 2)
    if cap == 0:
        mean = n / F
        cap = int(mean + 8 * (mean ** 0.5)) + 128 * n_tiles
    cap = -(-cap // 128) * 128 + mrr * 128
    return tile, n_tiles, mrr, cap


def _pids(hk: torch.Tensor, bits: int, skip_bits: int) -> torch.Tensor:
    """Partition id of each biased key (int64), F for the null key: the
    top `bits` of the unsigned key rotated left by skip_bits."""
    u = unbias(hk).to(torch.int64) & 0xFFFFFFFF
    if skip_bits:
        u = ((u << skip_bits) | (u >> (32 - skip_bits))) & 0xFFFFFFFF
    return torch.where(hk != BIAS, u >> (32 - bits), 1 << bits)


def _destinations(cnt: torch.Tensor, regions: int, mrr: int, cap: int):
    """Destination rows from the (regions * n_tiles, F) histogram, as the
    JAX function computes them: an exclusive scan of each run's rows over
    the tiles of its region; -1 marks an empty run, -2 a run past the
    region (fill + mrr > cap rows) or longer than mrr rows.  Returns
    (dst int32 like cnt, counts (regions * F,) int32, overflow: the number
    of regions with a -2 run, 0-d int32)."""
    F = cnt.shape[1]
    cnt3 = cnt.view(regions, -1, F).to(torch.int64)
    run_rows = (cnt3 + 127) // 128
    # the scan runs along the tiles; with the tiles innermost it is one
    # parallel scan per (region, partition) instead of a serial walk
    fill = torch.cumsum(run_rows.transpose(1, 2).contiguous(),
                        2).transpose(1, 2) - run_rows
    cap_rows = cap // 128
    base = torch.arange(regions * F, device=cnt.device).view(regions, 1, F)
    bad = (fill + mrr > cap_rows) | (run_rows > mrr)
    dst = torch.where(cnt3 == 0, -1,
                      torch.where(bad, -2, fill + base * cap_rows))
    counts = cnt3.sum(1).view(-1).to(torch.int32)
    overflow = (dst == -2).view(regions, -1).any(1).sum().to(torch.int32)
    return dst.view(-1, F).to(torch.int32), counts, overflow


def _empty(hk, bits: int, cap: int, regions: int):
    """No input slots: all pads, zero counts, no overflow, no launch."""
    F = 1 << bits
    capz = -(-max(cap, 128) // 128) * 128
    out_k = torch.full((regions * F * capz,), BIAS, dtype=torch.int32,
                       device=hk.device)
    return (out_k, torch.zeros_like(out_k),
            torch.zeros(regions * F, dtype=torch.int32, device=hk.device),
            torch.zeros((), dtype=torch.int32, device=hk.device))


def radix_partition_torch(hk, vals, bits: int, skip_bits: int = 0,
                          cap: int = 0, tile: int = 32768, regions: int = 1):
    """Plain version of ``radix_partition``: the histogram by bincount,
    each tuple's rank within its run by one stable sort of (tile,
    partition) ids, then one scatter."""
    _check(hk, vals, bits, skip_bits, tile, regions)
    n = hk.shape[0] // regions
    if n == 0:
        return _empty(hk, bits, cap, regions)
    F = 1 << bits
    tile, n_tiles, mrr, cap = geometry(n, bits, cap, tile)
    idx = torch.arange(hk.shape[0], device=hk.device)
    run = ((idx // n) * n_tiles + (idx % n) // tile) * (F + 1) \
        + _pids(hk, bits, skip_bits)  # null keys get their own run
    hist = torch.bincount(run, minlength=regions * n_tiles * (F + 1))
    dst, counts, overflow = _destinations(
        hist.view(-1, F + 1)[:, :F], regions, mrr, cap)
    run_s, order = torch.sort(run, stable=True)
    rank = idx - (torch.cumsum(hist, 0) - hist)[run_s]
    g, p = run_s // (F + 1), run_s % (F + 1)
    live = p < F
    d = dst[g, p.clamp(max=F - 1)].to(torch.int64)
    total = regions * F * cap
    slot = torch.where(live & (d >= 0), d * 128 + rank, total)
    out_k = torch.full((total + 1,), BIAS, dtype=torch.int32,
                       device=hk.device)
    out_v = torch.zeros(total + 1, dtype=torch.int32, device=hk.device)
    out_k[slot] = hk[order]
    out_v[slot] = vals[order]
    return out_k[:total], out_v[:total], counts, overflow


def radix_partition(hk, vals, bits: int, skip_bits: int = 0, cap: int = 0,
                    tile: int = 32768, regions: int = 1):
    """One radix pass on hash bits [31-skip_bits, 31-skip_bits-bits] of
    biased keys.  The input may hold `regions` equal regions, each
    partitioned on its own (one pass-k+1 call per pass-k region, in one
    launch).  Returns (out_hk, out_vals, counts, overflow): out_* are
    (regions * F * cap,) int32, region-major; counts (regions * F,) are
    exact; overflow (0-d int32) counts the regions where some run did not
    fit, whose output is then partial.  A CUDA tensor launches the
    kernels; a CPU tensor takes the plain version."""
    if hk.device.type == "cpu":
        return radix_partition_torch(hk, vals, bits, skip_bits, cap, tile,
                                     regions)
    _check(hk, vals, bits, skip_bits, tile, regions)
    n = hk.shape[0] // regions
    if n == 0:
        return _empty(hk, bits, cap, regions)
    F = 1 << bits
    tile, n_tiles, mrr, cap = geometry(n, bits, cap, tile)
    cnt = torch.empty((regions * n_tiles, F), dtype=torch.int32,
                      device=hk.device)
    _build.launch("hjk_radix_histogram", hk.device, hk, regions, n, tile,
                  n_tiles, bits, skip_bits, cnt)
    dst, counts, overflow = _destinations(cnt, regions, mrr, cap)
    out_k = torch.full((regions * F * cap,), BIAS, dtype=torch.int32,
                       device=hk.device)
    out_v = torch.zeros_like(out_k)
    _build.launch("hjk_radix_scatter", hk.device, hk, vals, regions, n, tile,
                  n_tiles, bits, skip_bits, dst, out_k, out_v,
                  scatter_geometry(bits)[0])
    _build.count_launch(radix_partition)
    return out_k, out_v, counts, overflow


radix_partition.launches = 0


def multipass_partition(hk, vals, pass_bits: tuple, skip_bits: int = 0,
                        tile: int = 32768):
    """Radix passes composed into a full partitioning (the reference's
    local multi-pass loop): pass k+1 partitions every pass-k region on
    its own, pads included, all regions in one batched call.  Returns
    (out_hk, out_vals, counts, overflow) over 2^sum(pass_bits) regions of
    equal capacity; overflow sums the per-region flags of every pass.

    The JAX function unrolls one call per region into its trace and caps
    the unroll at 64 calls, a TPU compile-time limit.  The batched pass
    has no such limit; the cap is kept only for parity."""
    if not pass_bits:
        raise ValueError("pass_bits must name at least one pass")
    calls = 1
    for b in pass_bits[:-1]:
        calls *= 1 << b
    if calls > 64:
        raise ValueError(
            f"multipass unroll of {calls} region calls exceeds the "
            "reference's compile-time cap (64); use fewer/larger leading "
            "passes"
        )
    k, v, counts, ovf = radix_partition(hk, vals, pass_bits[0], skip_bits,
                                        tile=tile)
    skip = skip_bits + pass_bits[0]
    for b in pass_bits[1:]:
        k, v, counts, o = radix_partition(k, v, b, skip, tile=tile,
                                          regions=counts.shape[0])
        ovf = ovf + o
        skip += b
    return k, v, counts, ovf
