"""CPRA: the partition-aware join with cross-worker re-aggregation, over
ranks.

Counterpart of ``hash_join_codes_knl_tpu/parallel/cpra.py``, the
re-architecture of the reference CPRA pipeline (cpra2.cpp:1697-1986):
the reference's threads radix-partition their slices and re-aggregate
the fragments across threads by memcpy (cpra2.cpp:1883-1906) before a
partition-parallel build and probe.  Here each rank packs its tuples
into per-owner buckets (owner = top log2(size) bits of the scrambled
key), one all-to-all delivers every rank its owned fragments, and the
single-device engine (engine/phj.py) joins them on the rank's device.

Buckets have a fixed capacity per (source, destination) pair, the
``inner_cap`` / ``outer_cap`` planning knobs; a bucket past its capacity
is counted and reported, never silently dropped.  The pack is a stable
sort into the dense table (ops/partition.py), or, with
``pack_impl="radix"``, one pass of the radix kernel
(``csrc/radix_partition.cu``), whose partition function is the owner
function.

Every rank calls a step with its own block of the relations (shard with
parallel/distributed.py ``shard_null_padded``); the result is
rank-local, as the JAX result is device-local, and the diagnostic
vector is the same on every rank.  Columns are raw keys and values as
int32 bits, 0 the null key (utils/hashing.py).
"""

from __future__ import annotations

import dataclasses

import torch

from ..engine.config import JoinPlan, plan_join
from ..engine.phj import (
    JoinResult,
    _merge_params,
    _merge_probe,
    _merge_sort_probe,
    _merge_sort_side,
    _merge_windows,
    downgrade_plan_opts,
    join,
    phj_join,
    replan_from_span,
)
from ..ops.partition import build_dense_table
from ..ops.radix_partition import radix_partition
from ..utils.hashing import (
    bias,
    hash_ratio,
    hashed_key,
    mod_inverse_u32,
    mul_u32,
    unbias,
)
from . import skew as skew_ops
from .distributed import Mesh, require_live_mesh, shard_null_padded

_U32_MASK = 0xFFFFFFFF
_RESULT_FIELDS = ("probe_keys", "probe_vals", "match_vals", "match_cnts",
                  "build_counts")


def pack_by_owner(keys, vals, owner, n_owners: int, cap: int):
    """Pack tuples into (n_owners, cap) buckets, each in input order and
    0-padded; returns (bucket keys, bucket values, counts).  A count past
    cap is the overflow signal (the tuples beyond cap are dropped);
    owners outside [0, n_owners) are dropped.  The dense-table pack with
    slots=cap, on biased keys so that its pads unbias to the null 0."""
    tk, tv, counts = build_dense_table(bias(keys), vals, owner, n_owners, cap)
    return unbias(tk), tv, counts


def pack_by_owner_radix(keys, vals, factor: int, c_bits: int, cap: int = 0):
    """The owner pack as one radix pass (csrc/radix_partition.cu): the
    owner is the top c_bits of hk = key * factor, the pass's own
    partition function, so the pass is the pack.  `cap` is the bucket
    capacity in tuples (rounded up to the pass's 128-row quantum; 0 =
    the pass's estimate), so cap-based planning holds as for the sort
    pack.  Buckets come back null-interleaved and carry hk, unbiased
    (pads 0); the caller multiplies by the modular inverse after the
    exchange.  Returns (bucket hk (C * capr,), values, counts (C,),
    overflow)."""
    bk, bv, counts, ovf = radix_partition(bias(hashed_key(keys, factor)),
                                          vals, c_bits, cap=cap)
    return unbias(bk), bv, counts, ovf


def _check_tier_plan(use_tiers: bool, plan: JoinPlan) -> None:
    """Tier routing needs a merge-mode local plan: the tier is a range
    hash of the factor-1 scramble, so each rank receives keys whose
    scrambled values crowd into its tier's slice, and a padded local join
    partitioning on the top bits would overflow its slots.  The merge
    engine sorts the full range and does not care."""
    if use_tiers and not plan.probe_impl.startswith("merge"):
        raise ValueError(
            "tier_ratio requires a merge-mode local plan: tier routing "
            "compresses each rank's factor-1 hash range, skewing padded "
            "top-bits partitioning -- use probe_impl='merge'"
        )


def _engine_overflow(res: JoinResult, local_plan: JoinPlan):
    """The local engine's overflow signal as a count (0 = clean): merge
    mode, window-overflow tiles plus plan-opt violations
    (build_counts[0] + [2]); radix mode, the summed pass overflow (the
    last entry: the partition counts there are measured against the
    pass's region capacity, not plan.slots); padded sort mode, the
    partitions past `slots`."""
    bc = res.build_counts
    if local_plan.probe_impl.startswith("merge"):
        return bc[0] + bc[2]
    if local_plan.partition_impl == "radix":
        return bc[-1]
    return (bc > local_plan.slots).sum()


def _engine_select_overflow(res: JoinResult, local_plan: JoinPlan):
    """Plan-opt violations (merge mode; 0 elsewhere): fixed by
    downgrade_plan_opts, not by a window change."""
    if local_plan.probe_impl.startswith("merge"):
        return res.build_counts[2]
    return res.build_counts.new_zeros(())


def _engine_span(res: JoinResult, local_plan: JoinPlan):
    """Measured max probe-window span (merge mode; 0 elsewhere), the
    re-planner's input (engine/phj.py replan_from_span)."""
    if local_plan.probe_impl.startswith("merge"):
        return res.build_counts[1]
    return res.build_counts.new_zeros(())


def _owner_bits(n_chips: int) -> int:
    bits = (n_chips - 1).bit_length()
    if 1 << bits != n_chips:
        raise ValueError(f"rank count must be a power of two, got {n_chips}")
    return bits


def _top_bits(keys, factor: int, bits: int, shift: int = 0):
    """Bits [32-shift, 32-shift-bits) of the unsigned scrambled key, as
    int64: a logical shift, which an arithmetic shift of int32 is not."""
    hk = hashed_key(keys, factor).to(torch.int64) & _U32_MASK
    return ((hk << shift) & _U32_MASK) >> (32 - bits)


def _make_owner_of(plan: JoinPlan, n_chips: int, c_bits: int,
                   tier_ratio: float | None = None):
    """Owner-rank routing: the top c_bits of the scrambled key, or the
    two-level tier hash when tier_ratio is set (simd_hash_ratio).  The
    null key routes to the out-of-range owner, which the pack drops."""
    use_tiers = tier_ratio is not None and n_chips >= 2

    def owner_of(keys):
        if use_tiers:
            own = hash_ratio(keys, plan.factor, n_chips, tier_ratio)
        elif c_bits == 0:
            own = torch.zeros(keys.shape, dtype=torch.int64,
                              device=keys.device)
        else:
            own = _top_bits(keys, plan.factor, c_bits)
        return torch.where(keys != 0, own, n_chips)

    return owner_of


def _exchange_sort(mesh: Mesh, keys, vals, owner, cap: int):
    """Sort pack and the all-to-all: (received keys, values, overflow)."""
    bk, bv, cnt = pack_by_owner(keys, vals, owner, mesh.size, cap)
    return (mesh.all_to_all(bk.view(-1)), mesh.all_to_all(bv.view(-1)),
            bool((cnt > cap).any()))


def _local_plan(plan: JoinPlan, c_bits: int, use_tiers: bool) -> JoinPlan:
    """The local engine skips the hash bits the owner routing consumed
    (constant within one owner).  Tier routing is no bit prefix, so no
    factor-1 bits are consumable; its local plan is merge mode, which
    never reads them."""
    skip = plan.skip_bits if use_tiers else plan.skip_bits + c_bits
    return dataclasses.replace(plan, skip_bits=skip)


def make_cpra_step(
    mesh: Mesh,
    plan: JoinPlan,
    inner_cap: int,
    outer_cap: int,
    skew: bool = False,
    heavy_k_max: int = 8,
    heavy_sample: int = 65536,
    heavy_frac: float = 1 / 256,
    heavy_build_cap: int = 256,
    tier_ratio: float | None = None,
    pack_impl: str = "sort",
):
    """The distributed join step on `mesh`.

    inner_cap / outer_cap: bucket capacities in tuples per (source,
    destination) pair.  tier_ratio (with at least two ranks): route with
    the reference's two-level tier hash (phj.cpp:101-116), a 100-bin
    split of the traffic between the mesh's halves at cut =
    (1 - ratio) * 100 -- the DDR/MCDRAM placement knob as a rank-group
    placement -- then an independent hash within the half.  pack_impl:
    "sort" (the stable-sort pack) or "radix" (one pass of the radix
    kernel; its buckets carry hk and keys are restored after the
    exchange); tier routing needs "sort".

    Returns fn(ik, iv, ok, ov) -> (JoinResult, heavy, diag) over this
    rank's blocks; the result is rank-local.  diag is the same (5,)
    int64 host tensor on every rank: [exchange-cap overflow count,
    engine overflow count, max probe-window span, heavy-build-cap
    overflow count, plan-opt violation count] -- separate because their
    fixes differ (more slack, a window re-planned from the span, a larger
    heavy_build_cap, downgraded plan flags).  With skew=True, heavy is
    the local heavy row set (probe keys, probe values, match values,
    match counts) aligned to the local probe block; otherwise None."""
    n_chips = mesh.size
    c_bits = _owner_bits(n_chips)
    if pack_impl not in ("sort", "radix"):
        # an unrecognized string must not silently run the sort pack
        raise ValueError(
            f"pack_impl must be 'sort' or 'radix', got {pack_impl!r}"
        )
    use_tiers = tier_ratio is not None and n_chips >= 2
    if pack_impl == "radix" and use_tiers:
        raise ValueError(
            "pack_impl='radix' is incompatible with tier_ratio: the "
            "tier hash is not a top-bits partition -- use the sort pack "
            "for tiered placement"
        )
    _check_tier_plan(use_tiers, plan)
    local_plan = _local_plan(plan, c_bits, use_tiers)
    owner_of = _make_owner_of(plan, n_chips, c_bits, tier_ratio)

    def step(ik, iv, ok, ov):
        heavy = None
        overflow = False
        heavy_ovf = False
        if skew:
            nom = skew_ops.nominate_heavy(ok, heavy_sample, heavy_k_max,
                                          heavy_frac)
            heavy_keys = mesh.all_gather(nom)
            i_heavy = skew_ops.is_member(ik, heavy_keys)
            o_heavy = skew_ops.is_member(ok, heavy_keys)
            hbk, hbv, hb_cnt = skew_ops.extract_rows(ik, iv, i_heavy,
                                                     heavy_build_cap)
            rep_k, rep_v = mesh.all_gather(hbk), mesh.all_gather(hbv)
            h_mval, h_mcnt = skew_ops.probe_small_table(ok, rep_k, rep_v)
            # a probe gets a local match only when it is flagged heavy
            h_mcnt = torch.where(o_heavy, h_mcnt, 0)
            h_mval = torch.where(o_heavy, h_mval, 0)
            heavy = (ok, ov, h_mval, h_mcnt)
            # its own diag entry: more exchange slack cannot fix a
            # truncated heavy-build extraction, only a larger cap
            heavy_ovf = bool(hb_cnt > heavy_build_cap)
            ik = torch.where(i_heavy, 0, ik)
            ok = torch.where(o_heavy, 0, ok)
        # the re-aggregation memcpy (cpra2.cpp:1896-1904) as one collective
        if pack_impl == "radix" and c_bits > 0:
            bik, biv, icnt, iovf = pack_by_owner_radix(
                ik, iv, plan.factor, c_bits, cap=inner_cap)
            bok, bov, ocnt, oovf = pack_by_owner_radix(
                ok, ov, plan.factor, c_bits, cap=outer_cap)
            # two layers: the pass's own capacity (tuples dropped) and
            # the planned caps (the same signal as the sort pack's)
            overflow = bool((iovf != 0) | (oovf != 0)
                            | (icnt > inner_cap).any()
                            | (ocnt > outer_cap).any())
            inv = mod_inverse_u32(plan.factor)
            rik = mul_u32(mesh.all_to_all(bik), inv)
            riv = mesh.all_to_all(biv)
            rok = mul_u32(mesh.all_to_all(bok), inv)
            rov = mesh.all_to_all(bov)
        else:
            rik, riv, iovf = _exchange_sort(mesh, ik, iv, owner_of(ik),
                                            inner_cap)
            rok, rov, oovf = _exchange_sort(mesh, ok, ov, owner_of(ok),
                                            outer_cap)
            overflow = iovf or oovf
        res = phj_join(rik, riv, rok, rov, local_plan)
        sums = mesh.all_sum([
            int(overflow), int(_engine_overflow(res, local_plan)),
            int(heavy_ovf), int(_engine_select_overflow(res, local_plan))])
        span = mesh.all_max([int(_engine_span(res, local_plan))])[0]
        diag = torch.tensor([sums[0], sums[1], span, sums[2], sums[3]],
                            dtype=torch.int64)
        return res, heavy, diag

    return step


def make_cpra_steps_staged(mesh: Mesh, plan: JoinPlan, inner_cap: int,
                           outer_cap: int, tier_ratio: float | None = None):
    """The CPRA pipeline as two stages for phase metering (the CLI's
    ``cpra --timelog``): `exchange`, the owner pack and the all-to-all
    (the re-aggregation copy the reference times on its own,
    cpra2.cpp:1895-1905), and `local_join`, the rank's PHJ.  Same
    semantics as make_cpra_step without skew.

    Returns (exchange_fn, join_fn): exchange_fn(ik, iv, ok, ov) -> (rik,
    riv, rok, rov, overflow), join_fn(rik, riv, rok, rov) ->
    (JoinResult, overflow); each overflow is the same bool on every
    rank."""
    n_chips = mesh.size
    c_bits = _owner_bits(n_chips)
    use_tiers = tier_ratio is not None and n_chips >= 2
    _check_tier_plan(use_tiers, plan)
    local_plan = _local_plan(plan, c_bits, use_tiers)
    owner_of = _make_owner_of(plan, n_chips, c_bits, tier_ratio)

    def exchange(ik, iv, ok, ov):
        rik, riv, iovf = _exchange_sort(mesh, ik, iv, owner_of(ik),
                                        inner_cap)
        rok, rov, oovf = _exchange_sort(mesh, ok, ov, owner_of(ok),
                                        outer_cap)
        return (rik, riv, rok, rov,
                bool(mesh.all_sum([int(iovf or oovf)])[0]))

    def local_join(rik, riv, rok, rov):
        res = phj_join(rik, riv, rok, rov, local_plan)
        ovf = int(_engine_overflow(res, local_plan) > 0)
        return res, bool(mesh.all_sum([ovf])[0])

    return exchange, local_join


def _concat_results(parts) -> JoinResult:
    return JoinResult(*(torch.cat([getattr(p, f) for p in parts])
                        for f in _RESULT_FIELDS))


def make_cpra_step_pipelined(mesh: Mesh, plan: JoinPlan, inner_cap: int,
                             outer_cap: int, chunks: int):
    """Chunked exchange/compute pipeline (BASELINE config 5: the exchange
    overlapped with build and probe).

    The build side is exchanged and sorted once; the probe block splits
    into `chunks` equal chunks, each packed, exchanged and joined against
    the shared build order.  Every chunk's all-to-all is started before
    any chunk is probed, so chunk k+1's exchange has no dependence on
    chunk k's probe (the JAX package's unrolled loop).  The chunks'
    results concatenate in chunk order.

    Returns fn(ik, iv, ok, ov) -> (JoinResult, overflow flag)."""
    n_chips = mesh.size
    c_bits = _owner_bits(n_chips)
    # probe_chunks=1: each pipeline chunk's probe side is sorted whole,
    # so the chunk-local window widening would be waste; the plan's
    # opportunistic flags are downgraded up front, because this step has
    # no retry loop to downgrade them after a counted violation
    local_plan = downgrade_plan_opts(dataclasses.replace(
        plan, skip_bits=plan.skip_bits + c_bits, probe_chunks=1))
    chunk_cap = -(-outer_cap // chunks)
    owner_of = _make_owner_of(plan, n_chips, c_bits)
    factor = local_plan.factor

    def step(ik, iv, ok, ov):
        if ok.shape[0] % chunks:
            raise ValueError(f"a probe block of {ok.shape[0]} rows does not "
                             f"split into {chunks} chunks")
        # build side: exchanged and sorted once
        bik, biv, icnt = pack_by_owner(ik, iv, owner_of(ik), n_chips,
                                       inner_cap)
        overflow = bool((icnt > inner_cap).any())
        rik = mesh.all_to_all(bik.view(-1))
        riv = mesh.all_to_all(biv.view(-1))
        ni, no = rik.shape[0], n_chips * chunk_cap
        tile, window, rows_total, cap = _merge_params(local_plan, ni, no)
        bhk, bval = _merge_sort_side(rik, riv, rows_total * 128, factor)
        # probe side: every chunk's exchange starts before any probe
        pending = []
        for o_c, v_c in zip(ok.view(chunks, -1), ov.view(chunks, -1)):
            bok, bov, ocnt = pack_by_owner(o_c, v_c, owner_of(o_c), n_chips,
                                           chunk_cap)
            overflow |= bool((ocnt > chunk_cap).any())
            pending.append((mesh.all_to_all(bok.view(-1), async_op=True),
                            mesh.all_to_all(bov.view(-1), async_op=True)))
        parts = []
        for k_work, v_work in pending:
            ohk, ov_s = _merge_sort_probe(k_work.wait(), v_work.wait(), cap,
                                          1, factor)
            wrow, stats = _merge_windows(bhk, ohk, tile, window, rows_total)
            parts.append(_merge_probe(bhk, bval, ohk, ov_s, wrow, stats,
                                      local_plan, tile, window))
        res = _concat_results(parts)
        # per part [overflow tiles, max span, violations]: fold the two
        # overflow entries (the span is a measurement)
        bc3 = res.build_counts.view(-1, 3)
        overflow |= bool((bc3[:, 0] + bc3[:, 2]).sum() > 0)
        return res, bool(mesh.all_sum([int(overflow)])[0])

    return step


def make_cpra_step_2level(host_mesh: Mesh, chip_mesh: Mesh, plan: JoinPlan,
                          inner_cap: int, outer_cap: int):
    """Two-level exchange for multi-host pods: the top hash bits route to
    a host first (one all-to-all over `host_mesh`, the slow hop, paid
    once), the next bits to a rank within the host (one all-to-all over
    `chip_mesh`).  The reference's two-level placement (simd_hash_ratio
    routes tier, then partition, phj.cpp:101-116) as a per-host and
    per-rank partition map (SURVEY.md section 2.5); a flat exchange over
    H * C ranks would push every misrouted tuple across the slow hop
    twice.  Make the two meshes with distributed.split_2level.

    inner_cap / outer_cap: bucket capacities at both levels.  Returns
    fn(ik, iv, ok, ov) over this rank's blocks (rank = h * C + c) ->
    (JoinResult, overflow flag)."""
    H, C = host_mesh.size, chip_mesh.size
    h_bits, c_bits = _owner_bits(H), _owner_bits(C)
    local_plan = dataclasses.replace(
        plan, skip_bits=plan.skip_bits + h_bits + c_bits)

    def exchange(mesh, keys, vals, bits, shift, cap):
        if bits == 0:
            return keys, vals, False
        own = _top_bits(keys, plan.factor, bits, shift)
        own = torch.where(keys != 0, own, mesh.size)
        return _exchange_sort(mesh, keys, vals, own, cap)

    def step(ik, iv, ok, ov):
        # level 1: the top h_bits over the host mesh; level 2: the next
        # c_bits within the host
        ik, iv, o1 = exchange(host_mesh, ik, iv, h_bits, 0, inner_cap)
        ok, ov, o2 = exchange(host_mesh, ok, ov, h_bits, 0, outer_cap)
        ik, iv, o3 = exchange(chip_mesh, ik, iv, c_bits, h_bits, inner_cap)
        ok, ov, o4 = exchange(chip_mesh, ok, ov, c_bits, h_bits, outer_cap)
        res = phj_join(ik, iv, ok, ov, local_plan)
        # the engine's overflow surfaces here as in make_cpra_step
        overflow = o1 or o2 or o3 or o4 or bool(
            _engine_overflow(res, local_plan) > 0)
        n = chip_mesh.all_sum([int(overflow)])
        return res, bool(host_mesh.all_sum(n)[0])

    return step


def cpra_join(
    inner_keys,
    inner_vals,
    outer_keys,
    outer_vals,
    mesh: Mesh,
    plan: JoinPlan | None = None,
    slack: float = 2.0,
    skew: bool = False,
    tier_ratio: float | None = None,
    retries: int = 2,
    liveness_timeout_s: float | None = 30.0,
    pack_impl: str = "sort",
    **skew_kw,
):
    """Front end, called by every rank with the same replicated host
    relations (numpy uint32 or np.memmap): shard, run the step, re-plan
    on overflow.  Runs on mesh.device.

    slack: bucket capacity over the uniform expectation.  skew=True
    replicates the heavy hitters (parallel/skew.py) and returns (light
    JoinResult, heavy row set, plan); otherwise (JoinResult, plan).  The
    result is rank-local; the join cardinality is the sum of every
    rank's join_tuples.  Without a plan, rank 0 plans for all.

    Overflow re-plans up to `retries` times, by source (the step's diag):
    exchange overflow doubles the slack, window overflow re-plans the
    window from the measured span (engine/phj.py replan_from_span, as
    the single-device join does), a heavy-build overflow quadruples
    heavy_build_cap, a plan-opt violation downgrades the plan's flags.
    A padded local plan's overflow cannot be re-planned and raises, and
    persistent overflow raises with a pointer to the fix.  On a one-rank
    mesh without skew the exchange is the identity and this is the
    single-device join() (no bucket pack)."""
    n_chips = mesh.size
    ni, no = len(inner_keys), len(outer_keys)
    if plan is None:
        plan = mesh.root_call(plan_join, ni // n_chips, no // n_chips,
                              device=mesh.device)
    if n_chips == 1 and not skew:
        return join(inner_keys, inner_vals, outer_keys, outer_vals, plan,
                    window_retries=retries, device=mesh.device)
    # stage boundary: fail fast with a diagnosis instead of hanging in
    # the exchange when a rank is gone
    require_live_mesh(mesh, liveness_timeout_s, stage="cpra_exchange")
    # with tier routing the heavier half receives max(r, 1-r) of the
    # traffic over n/2 ranks: 2*max(r, 1-r) times uniform
    tier_bias = 1.0
    if tier_ratio is not None and n_chips >= 2:
        tier_bias = 2.0 * max(tier_ratio, 1.0 - tier_ratio)
    args = [shard_null_padded(c, mesh) for c in
            (inner_keys, inner_vals, outer_keys, outer_vals)]
    for _ in range(retries + 1):
        inner_cap = max(64, int(ni / (n_chips * n_chips) * slack * tier_bias))
        outer_cap = max(plan.tile,
                        int(no / (n_chips * n_chips) * slack * tier_bias))
        step = make_cpra_step(mesh, plan, inner_cap, outer_cap, skew=skew,
                              tier_ratio=tier_ratio, pack_impl=pack_impl,
                              **skew_kw)
        res, heavy, diag = step(*args)
        exch_ovf, eng_ovf, span, heavy_ovf, sel_ovf = diag.tolist()
        if exch_ovf == 0 and eng_ovf == 0 and heavy_ovf == 0:
            return (res, heavy, plan) if skew else (res, plan)
        # free the failed attempt's buffers before retrying
        res = heavy = None
        if exch_ovf:
            slack *= 2.0
        if heavy_ovf:
            skew_kw = dict(skew_kw, heavy_build_cap=4 * skew_kw.get(
                "heavy_build_cap", 256))
        if eng_ovf:
            if not plan.probe_impl.startswith("merge"):
                raise RuntimeError(
                    "local join overflow on the padded path (table slots "
                    "or radix pass capacity exceeded): raise plan.slots "
                    "or the pass fanout -- window re-planning cannot fix "
                    "this"
                )
            if sel_ovf:
                plan = downgrade_plan_opts(plan)
            if eng_ovf > sel_ovf:
                plan = replan_from_span(plan, span)
    # diagnose by the signal that persisted on the last attempt
    if heavy_ovf:
        raise RuntimeError(
            "heavy-build extraction overflow persists after re-planning: "
            "pass a larger heavy_build_cap (more replicated build rows "
            "share heavy keys than the cap admits)"
        )
    if exch_ovf:
        raise RuntimeError(
            "exchange bucket overflow persists after re-planning: "
            "enable skew=True (heavy-hitter replication) for this "
            "workload"
        )
    raise RuntimeError(
        f"probe window overflow persists after re-planning (measured "
        f"span {span} slots): the duplicate-run span exceeds what the "
        "window geometry can absorb -- shrink plan.tile or "
        "probe_chunks, or enable skew=True"
    )
