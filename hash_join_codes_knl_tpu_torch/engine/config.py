"""Join plans: the runtime knob set.

Counterpart of ``hash_join_codes_knl_tpu/engine/config.py``.  `JoinPlan`
carries every field of the JAX plan, so that a JAX plan converts one to
one (`engine/convert.py`), and `plan_join` derives the same geometry.
The merge modes read `tile`, `window`, `probe_chunks`, the two-class
`window_wide` and `wide_cap`, and the opportunistic flags; the padded modes read `p_bits`, `slots`, `tile`,
`skip_bits` and `partition_impl`, and the radix mode `pass_bits`.
"""

from __future__ import annotations

import dataclasses

DEFAULT_FACTOR = 0x9E3779B1  # odd golden-ratio factor; any odd u32 works


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    p_bits: int  # total partition bits (padded paths only)
    slots: int  # build-table slots per partition (padded sort modes)
    tile: int  # probe tile = probe-side pad quantum (radix mode: 128)
    factor: int = DEFAULT_FACTOR
    pass_bits: tuple = ()  # per-pass radix bits (radix mode only)
    skip_bits: int = 0  # hash bits consumed by upstream routing
    # padded paths only: "sort" | "argsort" (one stable sort lays out
    # both; the JAX package's two forms agree slot for slot) | "radix"
    # (multi-pass radix partitioner)
    partition_impl: str = "sort"
    # merge modes: "merge" (sorted-window probe; resolves to a kernel by
    # window width) | "merge_pallas" (K2, the window hash table) |
    # "merge_gather" (K3, the staged-window search) | "merge_jnp" (plain
    # torch, for tests).  Padded modes: "auto" and "pallas" (the tile probe:
    # its kernel on a CUDA tensor, its plain version on a CPU tensor) |
    # "jnp" (always the plain version, with the table-count mask; for
    # tests)
    probe_impl: str = "merge"
    window: int = 0  # merge-mode probe window in slots (0 = auto estimate)
    # two-class window geometry (merge modes): window_wide > 0 re-probes
    # the tiles whose span exceeds the (explicit, narrower) `window` at
    # this width; wide_cap bounds how many (0 = max(8, tiles // 16))
    window_wide: int = 0
    wide_cap: int = 0
    # boundary-select engine of the JAX gather kernel; carried for plan
    # parity, no effect here (the port's gather kernel has one exact
    # select)
    gather_select: str = "auto"
    # declare the build keys unique; validated at run time and downgraded
    # by join() when the gather kernel finds adjacent duplicates
    unique_build: bool = False
    # sort the probe side as this many independent chunks (0/1 = one
    # global sort); each tile's window widens by about the chunk count
    probe_chunks: int = 0

    @property
    def num_partitions(self) -> int:
        return 1 << self.p_bits


def plan_join(inner_n: int, outer_n: int, tile: int | None = None,
              probe_chunks: int | None = None, device=None) -> JoinPlan:
    """Pick a plan with the JAX planner's geometry.

    At large probe counts (64M to 320M rows) the probe side is sorted as
    independent chunks with a 3072-row tile.  The chunk count is capped
    by window feasibility: a tile's chunk-local span, about
    tile * inner * C / outer, must fit the gather window ceiling with its
    margins (about 12.5K slots).  The candidates under that cap are then
    timed on the card by the plan-time tuner (engine/tune.py, cached per
    geometry and device name); on `device` "cpu", or without a card, the
    tuner's default min(64, c_win) comes back untimed, as the JAX
    planner's does off the TPU.  Small probes keep the global sort.
    """
    if probe_chunks is None:
        # above ~320M probe rows the chunked sort's workspace tipped a
        # 16 GB TPU into OOM (the JAX planner's rule, kept for parity):
        # larger relations go to engine/stream.py
        if 64_000_000 <= outer_n <= 320_000_000:
            from .tune import DEFAULT_CANDIDATES, tuned_probe_chunks

            t = tile if tile is not None else 3072
            c_win = int((12_500 * outer_n) // (t * max(inner_n, 1)))
            if c_win >= min(DEFAULT_CANDIDATES):
                # candidates the cap excludes are never timed; pass the
                # actual tile: the tuner caches per tile
                cands = tuple(C for C in DEFAULT_CANDIDATES if C <= c_win)
                probe_chunks = tuned_probe_chunks(
                    outer_n, tile=t, default=min(64, c_win),
                    candidates=cands, device=device)
            else:
                probe_chunks = c_win
            probe_chunks = int(max(0, min(probe_chunks, c_win)))
            if probe_chunks <= 1:
                probe_chunks = 0
        else:
            probe_chunks = 0
    if tile is None:
        tile = 3072 if probe_chunks else 2048
    p_bits = 1
    # mean build-partition occupancy <= 128 and mean probe partition >=
    # 2 tiles (the padded paths' fanout rule)
    while (inner_n >> p_bits) > 128 and (outer_n >> p_bits) >= 2 * tile:
        p_bits += 1
    mean_build = max(1, inner_n >> p_bits)
    slots = 1
    while slots < mean_build * 3 or slots < 64:
        slots *= 2
    remaining, passes = p_bits, []
    while remaining > 0:
        b = min(8, remaining)
        passes.append(b)
        remaining -= b
    return JoinPlan(p_bits=p_bits, slots=slots, tile=tile,
                    pass_bits=tuple(passes), probe_chunks=probe_chunks)
