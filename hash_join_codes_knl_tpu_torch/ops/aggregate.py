"""Hash aggregate: group-by-key reduction over relations and join output.

Counterpart of ``hash_join_codes_knl_tpu/ops/aggregate.py``, output for
output: group keys ascending (unsigned) and packed to the front, null
keys (0) ignored, pad tails PAD_KEY/0, u32 wraparound sums, int32
counts; the chunked form's partial budget, its overflow count and the
measured re-plans are the JAX package's.

Sort-group-reduce, as there, in plain torch:

1. one sort groups equal keys.  The sort key is ``keys - 1`` read as
   unsigned, which wraps the null key 0 to the top so nulls land last
   with no flag column; in the biased int32 domain that is
   ``bias(keys) - 1``, with the null key set to INT32_MAX, and nothing
   overflows.  Sort order among equal keys does not matter: sums and
   counts do not depend on it;
2. an int64 inclusive cumsum of the values (exact: n * 2^32 < 2^63)
   turns each run's sum into a difference of prefixes at run starts;
3. the run starts are compacted to the front by a cumsum of the
   run-start flags and one scatter (the JAX package sorts there: the TPU
   has no usable scatter).  Each start lands in the slot of its run's
   rank, the slot the JAX package's stable sort gives it;
4. group totals are neighbour differences of the compacted prefixes (the
   last group closes against the row's total), masked to 32 bits.

That scheme (`_reduce_runs`, batched over rows, with any number of value
columns) serves the single-level `hash_aggregate`, the per-chunk
partials of `hash_aggregate_chunked` and its second level.

Columns are int32 tensors holding uint32 bits (utils/hashing.py); counts
of groups and of overflow are 0-d int64 tensors.  No kernel: the JAX
package's aggregate is plain jnp.
"""

from __future__ import annotations

import torch

from ..utils.hashing import bias, u32_to_i32
from .expand import build_side, expand_join, greedy_blocks, matched_rows

PAD_KEY = 0
_U32_MASK = 0xFFFFFFFF
_I32_MAX = 2**31 - 1


def _reduce_runs(k_s, vcols):
    """Per-row run reduction of batched-sorted columns.

    k_s: (C, m) keys, each row sorted with its null keys (PAD_KEY) LAST
    (_null_last_sort); vcols: tuple of (C, m) value columns in the same
    order, uint32 bits in int32 or int64.  Returns (gk, sums, cnts, g):
    each row's run-start keys compacted to its front (PAD_KEY tails),
    the per-run u32 wraparound sum of every value column (int32 bits),
    the run lengths (int64), and g = groups per row (int64)."""
    C, m = k_s.shape
    dev = k_s.device
    valid = k_s != PAD_KEY
    newrun = valid.clone()
    newrun[:, 1:] &= k_s[:, 1:] != k_s[:, :-1]
    rank = torch.cumsum(newrun, dim=1)
    g = rank[:, -1]
    # run start i goes to column rank - 1; every other row to a spare
    # column m that is dropped
    slot = torch.where(newrun, rank - 1, m)

    def compact(x):
        out = x.new_zeros((C, m + 1))
        return out.scatter_(1, slot, x)[:, :m]

    col = torch.arange(m, device=dev).expand(C, m)
    pres, tots = [], []
    for v in vcols:
        v_live = torch.where(valid, v.to(torch.int64) & _U32_MASK, 0)
        csum = torch.cumsum(v_live, dim=1)
        pres.append(csum - v_live)  # prefix BEFORE each row
        tots.append(csum[:, -1:])
    # run-length prefix: valid rows are a per-row prefix after the sort,
    # so the count of rows before a run start is its column index
    pres.append(col)
    tots.append(valid.sum(dim=1, keepdim=True))
    live = col < g[:, None]
    last = col + 1 == g[:, None]
    outs = []
    for pre, tot in zip(pres, tots):
        p = compact(pre)
        nxt = torch.cat([p[:, 1:], p[:, -1:]], dim=1)
        red = torch.where(last, tot - p, nxt - p)
        outs.append(torch.where(live, red, 0))
    gk = torch.where(live, compact(k_s), PAD_KEY)
    sums = tuple(u32_to_i32(o & _U32_MASK) for o in outs[:-1])
    return gk, sums, outs[-1], g


def _null_last_sort(keys, vcols):
    """Sort (keys, *vcols) along the last dimension on keys - 1 read as
    unsigned: nonzero keys ascending, null keys last."""
    order_key = torch.where(keys != PAD_KEY, bias(keys) - 1, _I32_MAX)
    order = torch.sort(order_key, dim=-1).indices
    return (torch.gather(keys, -1, order),
            *(torch.gather(v, -1, order) for v in vcols))


def _empty(dev, overflow: bool = False):
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    out = (torch.zeros((), dtype=torch.int64, device=dev), z, z.clone(),
           z.clone())
    return (*out, out[0].clone()) if overflow else out


def hash_aggregate(keys, vals):
    """Group by key; returns (n_groups, group_keys, sums, counts), with
    the groups packed to the front and tails padded with PAD_KEY/0.

    Rows with key == PAD_KEY (null/padding) are ignored, which lets the
    aligned join output feed this directly without materialization."""
    n = keys.shape[0]
    if n == 0:
        return _empty(keys.device)
    k_s, v_s = _null_last_sort(keys, (vals,))
    gk, (sums,), counts, g = _reduce_runs(k_s.view(1, n), (v_s.view(1, n),))
    return g[0], gk.view(-1), sums.view(-1), counts.view(-1).to(torch.int32)


def hash_aggregate_chunked(keys, vals, chunks: int = 64,
                           partial_cap: int = 1 << 22):
    """Two-level sort-group-reduce: per-chunk batched sorts and partial
    aggregation, then one small aggregate over the packed partials.

    Level 1 sorts the input as `chunks` independent rows and reduces
    each chunk's runs to (key, partial sum, partial count) triples
    packed to the chunk's front.  Level 2 re-aggregates the partials:
    sums add, counts add.  Wins when distinct groups << rows; at groups
    ~ rows the partials don't shrink and `hash_aggregate` is the right
    call.

    partial_cap is a fixed capacity (per chunk: partial_cap // chunks
    slots).  A chunk with more groups than its slot budget OVERFLOWS:
    the count of dropped partials is returned as a value (engine
    convention) and the results must be discarded in favour of
    `hash_aggregate`, as `hash_aggregate_auto` does.

    Returns (n_groups, group_keys, sums, counts, overflow), the group
    arrays sized chunks * min(partial_cap // chunks, ceil(n / chunks))
    (packed to the front, PAD_KEY/0 tails)."""
    n = keys.shape[0]
    if n == 0:
        return _empty(keys.device, overflow=True)
    cap_c = max(1, partial_cap // chunks)
    m = -(-n // chunks)
    pad = chunks * m - n
    k_p = torch.cat([keys, keys.new_zeros(pad)]).view(chunks, m)
    v_p = torch.cat([vals, vals.new_zeros(pad)]).view(chunks, m)
    k_s, v_s = _null_last_sort(k_p, (v_p,))
    del k_p, v_p
    gk, (ps,), pc, g = _reduce_runs(k_s, (v_s,))
    del k_s, v_s
    overflow = (g - cap_c).clamp(min=0).sum()
    # overflowing chunks lose their tail groups, which is exactly what
    # `overflow` counts
    gk_c = gk[:, :cap_c].reshape(-1)
    ps_c = ps[:, :cap_c].reshape(-1)
    pc_c = pc[:, :cap_c].reshape(-1)
    return (*_aggregate_partials(gk_c, ps_c, pc_c), overflow)


def _aggregate_partials(gk, ps, pc):
    """Level 2: aggregate (key, partial sum, partial count) triples,
    both value columns adding.  Returns (n_groups, group_keys, sums,
    counts)."""
    N2 = gk.shape[0]
    k2, s2, c2 = _null_last_sort(gk, (ps, pc))
    gk2, (sums, counts), _, g2 = _reduce_runs(
        k2.view(1, N2), (s2.view(1, N2), c2.view(1, N2)))
    return (g2[0], gk2.view(-1), sums.view(-1),
            counts.view(-1).to(torch.int32))


def hash_aggregate_auto(keys, vals, chunks: int = 64,
                        partial_cap: int = 1 << 22):
    """Two-level aggregate with a MEASURED re-plan (engine convention:
    overflow is a value, and the next plan is sized from it).  When a
    chunk overflows its partial budget, the dropped-partial count bounds
    the worst chunk's true group count: dropped = sum_c max(g_c - cap_c,
    0) >= max_c(g_c) - cap_c, so ONE retry at cap_c + dropped slots per
    chunk is guaranteed clean.  Only when that re-planned partial size
    reaches the input size (groups ~ rows) does it fall back to the
    single-level `hash_aggregate`.  Exact for any input, same return
    contract as hash_aggregate."""
    n = keys.shape[0]
    n_groups, gk, sums, counts, ovf = hash_aggregate_chunked(
        keys, vals, chunks=chunks, partial_cap=partial_cap)
    dropped = int(ovf)
    if dropped != 0:
        cap_c = max(1, partial_cap // chunks)
        new_cap = chunks * (cap_c + dropped)
        if new_cap >= n:
            return hash_aggregate(keys, vals)
        n_groups, gk, sums, counts, ovf = hash_aggregate_chunked(
            keys, vals, chunks=chunks, partial_cap=new_cap)
        if int(ovf) != 0:
            raise RuntimeError("re-planned partial budget overflowed")
    return n_groups, gk, sums, counts


def _expand_block_partials(build_keys, build_vals, pk_b, pv_b,
                           cap: int, budget: int):
    """One M:N block, on the device: expand the block's probe rows
    against the build relation into `cap` rows, aggregate the expanded
    (probe key -> build value) rows, and return the partials cut to
    `budget` slots: (row count, group count, keys, sums, counts as u32
    bits).  The group count lets the caller detect a budget overflow and
    re-plan from it."""
    total, out_k, _out_v, out_t = expand_join(build_keys, build_vals, pk_b,
                                              pv_b, cap)
    ng, gk, sums, counts = hash_aggregate(out_k, out_t)
    return total, ng, gk[:budget], sums[:budget], counts[:budget]


def aggregate_join_result_expanded(res, inner_keys, inner_vals,
                                   block_rows: int = 1 << 22,
                                   partial_budget: int = 1 << 20):
    """Device-side M:N aggregate: group the EXPANDED join output by probe
    key, summing matched build values, without bringing the expansion to
    the host.

    Matched probe rows are split into blocks whose expansions fit
    `block_rows` (greedy_blocks, as materialize_expanded), each block is
    expanded and partially aggregated on the device
    (_expand_block_partials), and the per-block partials are reduced as
    the chunked aggregate's second level (sums add, counts add).  Only
    the match counts come to the host, to plan the blocks.

    partial_budget caps each block's partial slots.  A block with more
    groups than the budget is detected from its group count, and ALL
    blocks re-run once at the measured largest group count (exact: a
    block of `cap` rows has at most `cap` groups).

    Returns (n_groups, group_keys, sums, counts) exactly like
    aggregate_join_result; on match counts <= 1 both give identical
    results."""
    pk, pv, counts = matched_rows(res)
    if int(counts.sum()) == 0:
        return _empty(pk.device)
    ik, iv = build_side(inner_keys, inner_vals, pk.device)
    block_rows = max(block_rows, int(counts.max()))
    cap = -(-block_rows // 128) * 128
    budget = min(cap, -(-partial_budget // 128) * 128)
    blocks = list(greedy_blocks(counts, block_rows))

    def run_blocks(budget: int):
        parts, max_ng = [], 0
        for start, stop, blk_total in blocks:
            got, ng, *part = _expand_block_partials(
                ik, iv, pk[start:stop], pv[start:stop], cap, budget)
            if int(got) != blk_total:
                raise RuntimeError(f"expansion gave {int(got)} rows for a "
                                   f"block of {blk_total} matches")
            max_ng = max(max_ng, int(ng))
            parts.append(part)
        return parts, max_ng

    parts, max_ng = run_blocks(budget)
    if max_ng > budget:
        # measured re-plan at the worst block's group count (<= cap, so
        # the second pass cannot overflow)
        budget = min(cap, -(-max_ng // 128) * 128)
        parts, max_ng = run_blocks(budget)
    return _aggregate_partials(*(torch.cat(c) for c in zip(*parts)))


def aggregate_join_result(res):
    """Hash aggregate over a JoinResult: group matched rows by probe key,
    summing the matched build values.  Unmatched and padded slots are
    nulled out and ignored.

    Requires match counts <= 1 (the aligned output): like materialize(),
    this refuses duplicate-key builds instead of silently under-counting
    them (aggregate_join_result_expanded is the M:N form)."""
    mc = res.match_cnts.reshape(-1)
    if mc.numel() and int(mc.max()) > 1:
        raise ValueError(
            "multi-match rows present; use aggregate_join_result_expanded "
            "(or materialize_expanded and aggregate the expanded columns)"
        )
    keys = torch.where(mc == 1, res.probe_keys.reshape(-1), PAD_KEY)
    return hash_aggregate(keys, res.match_vals.reshape(-1))
