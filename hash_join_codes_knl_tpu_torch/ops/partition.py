"""The padded partition layout and the dense build table, in plain torch.

Counterpart of ``hash_join_codes_knl_tpu/ops/partition.py``.  Partition
ids are high-bit groups of the scrambled key; the probe side is laid out
partition by partition, each region padded to a multiple of the probe
tile so that no tile straddles two partitions; the build side is packed
into a dense (P, slots) table, one row per partition.  All offsets come
from prefix sums.

Key domain (utils/hashing.py): keys are biased scrambled keys, so every
pad slot holds the biased null key ``BIAS`` (INT32_MIN) and a zero
value, where the JAX package pads with key 0.

The JAX package has an argsort form and a fused-sort form of each
operator (``partition_impl`` "argsort" and "sort").  Both place every
tuple by one STABLE sort of the partition ids, so they agree slot for
slot; torch has one stable sort, and the single function here serves
both.  No kernel: the layout is a sort, a histogram and one scatter.
"""

from __future__ import annotations

import torch

from ..utils.hashing import BIAS, unbias

PROBE_TILE_GROUP = 8  # the JAX probe scan's tiles per step; aligns cap


def pids_from_hk(hk: torch.Tensor, p_bits: int, skip_bits: int = 0,
                 null_pid: int | None = None) -> torch.Tensor:
    """Partition id of each biased scrambled key: the p_bits that start
    skip_bits below the top of the unsigned key.  skip_bits > 0 serves
    stages whose routing already consumed the top bits.  null_pid
    (usually P) routes the null key out of partition 0.  Returns int32.

    The shift is done on the unbiased bits: an arithmetic shift of int32
    followed by a mask equals the JAX package's logical shift of uint32."""
    if not (1 <= p_bits <= 31 and skip_bits >= 0
            and p_bits + skip_bits <= 32):
        raise ValueError(f"need 1 <= p_bits <= 31 and p_bits + skip_bits "
                         f"<= 32 (p_bits={p_bits}, skip_bits={skip_bits})")
    u = unbias(hk)
    pid = (u >> (32 - skip_bits - p_bits)) & ((1 << p_bits) - 1)
    if null_pid is not None:
        pid = torch.where(hk != BIAS, pid, null_pid)
    return pid.to(torch.int32)


def padded_capacity(n: int, num_partitions: int, quantum: int) -> int:
    """Static size of the padded layout: n plus one quantum of padding
    per partition, rounded up to PROBE_TILE_GROUP quanta."""
    cap = -(-n // quantum) * quantum + num_partitions * quantum
    align = PROBE_TILE_GROUP * quantum
    return -(-cap // align) * align


def _sorted_by_pid(keys, vals, pids, P: int):
    """Stable sort by partition id, out-of-range ids last.  Returns
    (sorted ids with P for dropped tuples, keys, vals, counts (P,),
    within-partition rank of each sorted tuple)."""
    valid = (pids >= 0) & (pids < P)
    spid = torch.where(valid, pids, P).to(torch.int32)
    pid_s, order = torch.sort(spid, stable=True)
    hist = torch.bincount(spid, minlength=P + 1)
    starts = torch.cumsum(hist, 0) - hist
    rank = torch.arange(keys.shape[0], device=keys.device) - starts[pid_s]
    return pid_s, keys[order], vals[order], hist[:P].to(torch.int32), rank


def partition_padded(keys: torch.Tensor, vals: torch.Tensor,
                     pids: torch.Tensor, num_partitions: int, quantum: int):
    """Stable partition into the padded layout, for both the JAX
    package's ``partition_padded_jnp`` and ``partition_padded_sort_jnp``.

    Region p is out[offsets[p] : offsets[p+1]]: its tuples in input
    order, then the null key up to the next quantum multiple.  Tuples
    whose pid is outside [0, P) are dropped.  Returns (out_keys,
    out_vals, offsets (P+1,), counts (P,)), all int32."""
    n, P = keys.shape[0], num_partitions
    cap = padded_capacity(n, P, quantum)
    pid_s, k_s, v_s, counts, rank = _sorted_by_pid(keys, vals, pids, P)
    padded = (counts.to(torch.int64) + quantum - 1) // quantum * quantum
    offsets = torch.zeros(P + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(padded, 0, out=offsets[1:])
    # dropped tuples land in one spare slot past the end
    dest = torch.where(pid_s < P, offsets[pid_s.clamp(max=P - 1)] + rank, cap)
    out_k = torch.full((cap + 1,), BIAS, dtype=torch.int32, device=keys.device)
    out_v = torch.zeros(cap + 1, dtype=torch.int32, device=keys.device)
    out_k[dest] = k_s
    out_v[dest] = v_s
    return out_k[:cap], out_v[:cap], offsets.to(torch.int32), counts


def build_dense_table(keys: torch.Tensor, vals: torch.Tensor,
                      pids: torch.Tensor, num_partitions: int, slots: int):
    """Dense (P, slots) build table, for both ``build_dense_table_jnp``
    and ``build_dense_table_sort_jnp``: row p holds partition p's tuples
    in input order, then the null key.  Tuples past `slots` are dropped;
    counts keep the true occupancy, so count > slots is the overflow the
    caller reports.  Returns (table_keys, table_vals, counts (P,))."""
    P = num_partitions
    pid_s, k_s, v_s, counts, rank = _sorted_by_pid(keys, vals, pids, P)
    dest = torch.where((pid_s < P) & (rank < slots),
                       pid_s.to(torch.int64) * slots + rank, P * slots)
    tk = torch.full((P * slots + 1,), BIAS, dtype=torch.int32,
                    device=keys.device)
    tv = torch.zeros(P * slots + 1, dtype=torch.int32, device=keys.device)
    tk[dest] = k_s
    tv[dest] = v_s
    return tk[:-1].view(P, slots), tv[:-1].view(P, slots), counts


def tile_pids(offsets: torch.Tensor, n_tiles: int, tile: int) -> torch.Tensor:
    """Partition owning each probe tile of the padded layout (regions are
    tile-aligned, so ownership is unique).  Trailing tiles past the last
    region map to the last partition; they hold only pads.  int32."""
    starts = torch.arange(n_tiles, device=offsets.device) * tile
    pid = torch.searchsorted(offsets.to(torch.int64), starts, right=True) - 1
    return pid.clamp(0, offsets.shape[0] - 2).to(torch.int32)
