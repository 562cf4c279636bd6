"""NPJ: the no-partition hash join against one global table.

Counterpart of ``hash_join_codes_knl_tpu/engine/npj.py`` (the reference's
``npj`` binary, npj.cpp:769-927): one open-addressing table over the
whole build side, probed directly.

Build: a linear-probe table's cluster structure does not depend on the
insertion order, so the table is laid out directly: sort the tuples by
(home bucket, key, value), then park each at slot_i = max(h_i,
slot_{i-1} + 1), i.e. slot_i = i + cummax(h_i - i), and scatter.  The
table has a non-wrapping margin past the last bucket.  Table keys are
the RAW keys, biased on the device (``key ^ 0x80000000``), so an empty
slot holds the null key INT32_MIN, as everywhere in the port.

Probe, two engines:

* "sorted" (default): the table is ordered by home bucket, and a key's
  matches lie in [h0, h0 + max_disp].  Probes are sorted by (home
  bucket, key), each probe tile is swept against its bucket-range window
  by the dense window probe (K2, ops/merge_probe.py: the kernel on a
  CUDA tensor, its plain version on a CPU tensor), and the results go
  back to the input order by one scatter (``order="input"``) or stay in
  the sorted order (``order="sorted"``).  Windows of the parked table
  are not key-sorted, so the probe is K2, which needs no sorted window
  (its hash table of a window skips the empty slots).
* "chain": the chain walk, a loop of gathers over the active probes in
  plain torch (the JAX package runs it in XLA, outside Pallas).  It is
  the semantic oracle and the ``npj_chain`` ablation.

Output: per probe tuple, the max matched build value and the match count.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.merge_probe import merge_probe
from ..utils.hashing import BIAS, bias, range_hash
from .config import DEFAULT_FACTOR
from .phj import DENSE_ROWCHUNK_BUDGET, _as_column

_U32_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NpjPlan:
    buckets: int  # table size (home-bucket range)
    margin: int = 4096  # non-wrapping overflow slots past the end
    factor: int = DEFAULT_FACTOR
    max_chain: int = 1 << 20  # safety bound on the chain walk
    # build keys are known distinct: a probe retires at its first match
    # (the chain walk's _UNIQUE mode, npj.cpp:954-956)
    unique: bool = False
    probe_impl: str = "sorted"  # "sorted" | "chain"
    tile: int = 2048  # sorted-probe tile (pad quantum)
    window: int = 0  # sorted-probe window in slots (0 = auto estimate)

    @property
    def table_size(self) -> int:
        """buckets + margin, rounded up to a 128 multiple (the sorted
        probe's window rows)."""
        return -(-(self.buckets + self.margin) // 128) * 128

    @property
    def max_window(self) -> int:
        """Widest sorted-probe window at this tile: the JAX package's
        dense-kernel TPU compile budget, kept for parity (PERF.md open
        questions)."""
        chunks = max(3, DENSE_ROWCHUNK_BUDGET // max(1, self.tile // 128))
        return chunks * 128

    def auto_window(self, probes: int, disp: int = 384) -> int:
        """Window for the sorted probe: a tile's expected home-bucket span
        (tile / probes of the bucket range) plus the parking displacement
        (pass the measured max_disp) plus an order-statistic margin,
        clamped to the table size and max_window."""
        lam = self.tile * self.buckets / max(probes, 1)
        w = int(lam + 8 * (lam ** 0.5) + max(384, disp))
        return min(-(-w // 128) * 128, self.table_size, self.max_window)


def plan_npj(inner_n: int, load: float = 0.5) -> NpjPlan:
    """Reference sizing, buckets = inner / load (npj.cpp:944-947 uses
    0.9; 0.5 as in the JAX package), rounded up to a power of two."""
    buckets = 1
    while buckets * load < inner_n:
        buckets *= 2
    return NpjPlan(buckets=buckets)


def npj_build(inner_keys, inner_vals, plan: NpjPlan):
    """Returns (table_keys, table_vals, overflow, max_disp): biased raw
    keys and value bits, (table_size,) int32 each, the count of tuples
    dropped past the margin, and the largest parking displacement of a
    kept tuple (every key's matches lie in [h0, h0 + max_disp]).  Null
    keys are dropped."""
    n = inner_keys.shape[0]
    size = plan.table_size
    dev = inner_keys.device
    h = range_hash(inner_keys, plan.factor, plan.buckets)
    h = torch.where(inner_keys != 0, h, size)  # nulls park past the end
    # (h, key, value) order: one sort of the packed (biased key, value),
    # then a stable sort by home bucket
    packed = ((bias(inner_keys).to(torch.int64) << 32)
              | (inner_vals.to(torch.int64) & _U32_MASK))
    packed, order = torch.sort(packed)
    h_s, order = torch.sort(h[order], stable=True)
    packed = packed[order]
    j = torch.arange(n, device=dev)
    slot = j + torch.cummax(h_s - j, 0).values if n else j
    slot = torch.where((h_s < size) & (slot < size), slot, size)  # drop
    # one slot past the table takes every dropped tuple, then goes
    tk = torch.full((size + 1,), BIAS, dtype=torch.int32, device=dev)
    tv = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    tk[slot] = (packed >> 32).to(torch.int32)
    tv[slot] = packed.to(torch.int32)
    overflow = (slot >= size).sum() - (h_s >= size).sum()
    kept = slot < size
    max_disp = (torch.where(kept, slot - h_s, 0).max() if n
                else overflow.new_zeros(()))
    return tk[:size], tv[:size], overflow, max_disp


def npj_probe(table_keys, table_vals, probe_keys, plan: NpjPlan):
    """The chain walk: each live probe steps from its home bucket to the
    first empty slot (or the table end), counting equal keys and keeping
    the max matched value.  Each step gathers only the probes still
    active.  Returns (match_vals, match_cnts), int32 in the input
    order."""
    n = probe_keys.shape[0]
    size = table_keys.shape[0]
    dev = probe_keys.device
    mval = torch.zeros(n, dtype=torch.int64, device=dev)
    mcnt = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.nonzero(probe_keys != 0).view(-1)
    h0 = range_hash(probe_keys[idx], plan.factor, plan.buckets)
    bk = bias(probe_keys[idx])
    off = 0
    while idx.numel() and off < plan.max_chain:
        slot = (h0 + off).clamp(max=size - 1)
        tk = table_keys[slot]
        eq = tk == bk
        tv = table_vals[slot].to(torch.int64) & _U32_MASK
        hit = idx[eq]
        mval[hit] = torch.maximum(mval[hit], tv[eq])
        mcnt[hit] += 1
        active = (tk != BIAS) & (h0 + off + 1 < size)
        if plan.unique:
            active &= ~eq  # the first match retires the probe
        idx, h0, bk = idx[active], h0[active], bk[active]
        off += 1
    return mval.to(torch.int32), mcnt


def sorted_probe_layout(probe_keys, plan: NpjPlan, size: int,
                        window: int):
    """The sorted probe's layout: probes padded to a tile multiple and
    sorted by (home bucket, key), one stable sort of the packed int64
    (h0 << 32) | key.  Returns (k_s, perm, wrow, hi, window): the sorted
    raw keys (pads are key 0), the permutation from the padded input, each
    tile's anchor row (int32), its last home bucket, and the window
    rounded up to the 128-slot quantum and clamped to the table (a wider
    window would anchor before the table start)."""
    n = probe_keys.shape[0]
    rows_total = size // 128
    tile = plan.tile
    cap = -(-n // tile) * tile
    window = min(-(-window // 128) * 128, rows_total * 128)
    h0 = range_hash(probe_keys, plan.factor, plan.buckets)
    # pads (key 0) park at the last bucket, so mixed tiles keep a sane span
    h0 = torch.where(probe_keys != 0, h0, plan.buckets - 1)
    pad = cap - n
    h0p = torch.cat([h0, h0.new_full((pad,), plan.buckets - 1)])
    kp = torch.cat([probe_keys, probe_keys.new_zeros(pad)])
    # h0 < 2^31, so the packed value is never negative; the stable sort
    # makes CPU and CUDA runs agree slot for slot
    packed = (h0p << 32) | (kp.to(torch.int64) & _U32_MASK)
    packed, perm = torch.sort(packed, stable=True)
    h0_s = packed >> 32
    k_s = packed.to(torch.int32)  # the low word: the raw key bits
    wrow = (h0_s[::tile] // 128).clamp(0, rows_total - window // 128)
    return k_s, perm, wrow.to(torch.int32), h0_s[tile - 1 :: tile], window


def npj_probe_sorted(table_keys, table_vals, probe_keys, plan: NpjPlan,
                     max_disp, window: int, probe_vals=None,
                     order: str = "input"):
    """Home-bucket-ordered window probe.

    Probes are laid out by ``sorted_probe_layout``; tile t is probed
    against the table slots [wrow[t] * 128, + window) by K2.

    order="input": returns (match_vals, match_cnts, overflow) in the
    probe input order, restored by one scatter by the carried index.
    order="sorted": returns (probe_keys, probe_vals, match_vals,
    match_cnts, overflow) in the sorted order at the padded capacity
    (pads carry key 0 and zero counts; needs probe_vals).

    overflow counts tiles whose required span (tile max h0 + max_disp +
    1, clamped to the table end, minus the window start) exceeds the
    window: a value to re-plan on."""
    if order == "sorted" and probe_vals is None:
        raise ValueError("order='sorted' needs probe_vals")
    n = probe_keys.shape[0]
    size = table_keys.shape[0]
    k_s, perm, wrow, hi, window = sorted_probe_layout(probe_keys, plan,
                                                      size, window)
    pad = k_s.shape[0] - n
    # the required span clamps to the table end: a cluster parked near
    # the tail cannot extend past it
    need_end = (hi + max_disp + 1).clamp(max=size)
    overflow = (need_end - wrow.to(torch.int64) * 128 > window).sum()
    mv, mc = merge_probe(bias(k_s), table_keys, table_vals, wrow, plan.tile,
                         window)
    if order == "sorted":
        carry = torch.cat([probe_vals, probe_vals.new_zeros(pad)])
        return k_s, carry[perm], mv, mc, overflow
    # back to the input order: one scatter by the permutation
    mv_o = torch.empty_like(mv)
    mc_o = torch.empty_like(mc)
    mv_o[perm] = mv
    mc_o[perm] = mc
    return mv_o[:n], mc_o[:n], overflow


def npj_join(inner_keys, inner_vals, outer_keys, outer_vals,
             plan: NpjPlan | None = None, window_retries: int = 3,
             order: str = "input", device=None):
    """Full NPJ.  Columns are 1-D int32 bit tensors or numpy uint32
    arrays, which go to ``device`` (by default the card; ``device="cpu"``
    runs the plain versions).

    order="input": returns (match_vals, match_cnts, plan) aligned to the
    outer input order.  order="sorted" (sorted engine only): returns
    (probe_keys, probe_vals, match_vals, match_cnts, plan) in
    home-bucket order at the padded capacity, the PHJ merge engine's
    aligned contract.

    A build overflow past the margin raises.  A sorted-probe window
    overflow re-plans: an undersized window jumps to the auto estimate,
    then doubles up to max_window, then the tile halves (down to 512);
    past that it raises."""
    if order not in ("input", "sorted"):
        raise ValueError(f"order must be 'input' or 'sorted', got {order!r}")
    if plan is None:
        plan = plan_npj(len(inner_keys))
    if plan.probe_impl == "chain" and order != "input":
        raise ValueError(
            "order='sorted' applies to the sorted probe engine only "
            "(the chain walk is input-ordered by construction)"
        )
    cols = [_as_column(c, device) for c in
            (inner_keys, inner_vals, outer_keys, outer_vals)]
    if len({c.device for c in cols}) != 1:
        raise ValueError("all four columns must be on one device")
    ik, iv, ok, ov = cols
    tk, tv, overflow, max_disp = npj_build(ik, iv, plan)
    if int(overflow) > 0:
        raise RuntimeError(
            f"{int(overflow)} build tuples overflowed the table margin; "
            "increase NpjPlan.margin or lower the load factor"
        )
    if plan.probe_impl == "chain":
        mv, mc = npj_probe(tk, tv, ok, plan)
        return mv, mc, plan
    ov_arg = ov if order == "sorted" else None
    # fold the measured displacement into the first window
    disp = int(max_disp) + 128
    n_probe = ok.shape[0]
    window = plan.window or plan.auto_window(n_probe, disp)
    for _ in range(window_retries + 1):
        size_cap = min(plan.table_size, plan.max_window)
        window = min(window, size_cap)
        out = npj_probe_sorted(tk, tv, ok, plan, max_disp, window,
                               probe_vals=ov_arg, order=order)
        wovf = int(out[-1])
        if wovf == 0:
            break
        out = None  # free the failed attempt before retrying
        if window < size_cap:
            window = min(max(2 * window, plan.auto_window(n_probe, disp)),
                         size_cap)
        elif plan.tile > 512:
            # tile spans scale with the tile, the window cap inversely
            plan = dataclasses.replace(plan, tile=plan.tile // 2)
            window = plan.auto_window(n_probe, disp)
        else:
            break
    if wovf != 0:
        raise RuntimeError(
            "sorted-probe window overflow persists at the widest window "
            "and the smallest tile: tile spans exceed the dense sweep's "
            "range (very few probes against a large table); use the PHJ "
            "merge engine for this shape, or raise the load factor"
        )
    final = dataclasses.replace(plan, window=window)
    if order == "sorted":
        k_s, v_s, mv, mc, _ = out
        return k_s, v_s, mv, mc, final
    mv, mc, _ = out
    return mv, mc, final
