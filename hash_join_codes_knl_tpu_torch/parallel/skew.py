"""Heavy-hitter handling for the distributed exchange (BASELINE configs 4-5).

Counterpart of ``hash_join_codes_knl_tpu/parallel/skew.py``.  A Zipf
probe stream puts most of its mass on a few keys, and the owner
exchange would send every copy of a heavy key to one rank and overflow
its bucket.  Instead the heavy build tuples are replicated:

1. every rank counts a leading sample of its probe block (the
   generator's shuffle makes any contiguous slice a uniform sample) and
   nominates the keys above a frequency threshold;
2. the nominations are all-gathered into one candidate list (a key
   nominated twice is harmless);
3. the heavy build tuples are all-gathered to every rank, and the heavy
   probe tuples are nulled out of the exchange and joined locally
   against that small table: they never cross the interconnect.

The result is two aligned row sets (exchanged light rows and local heavy
rows) whose union is the join output.

Columns hold raw keys as int32 bits (utils/hashing.py), 0 the null key.
The JAX functions broadcast (n, m) comparisons that XLA fuses; eagerly
that would materialize n * m booleans (hundreds of GB at 256M probes),
so membership and the small-table probe search a sorted copy of the
small side instead, with the same results slot for slot.  Plain torch:
none of these is a Pallas kernel in the JAX package.
"""

from __future__ import annotations

import torch

from ..utils.hashing import BIAS, bias

_U32_MASK = 0xFFFFFFFF


def nominate_heavy(keys: torch.Tensor, sample: int, k_max: int,
                   heavy_frac: float) -> torch.Tensor:
    """The top keys of the first `sample` local keys by frequency:
    (min(k_max, sample),) slots, 0-padded, most frequent first (ties in
    unsigned key order).  A key qualifies above heavy_frac of the sample
    (two hits at least)."""
    s = keys[: min(sample, keys.shape[0])]
    n = s.shape[0]
    runs, counts = torch.unique_consecutive(torch.sort(bias(s)).values,
                                            return_counts=True)
    thr = max(2, int(heavy_frac * n))
    cand = (counts >= thr) & (runs != BIAS)
    ck, cc = bias(runs[cand]), counts[cand]
    order = torch.sort(-cc, stable=True).indices
    out = torch.zeros(min(k_max, n), dtype=keys.dtype, device=keys.device)
    top = ck[order][: out.shape[0]]
    out[: top.shape[0]] = top
    return out


def is_member(keys: torch.Tensor, heavy_keys: torch.Tensor) -> torch.Tensor:
    """Membership of each live key in the (small, 0-padded) heavy list."""
    if heavy_keys.numel() == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    table = torch.sort(bias(heavy_keys)).values
    bk = bias(keys)
    pos = torch.searchsorted(table, bk).clamp(max=table.numel() - 1)
    return (table[pos] == bk) & (keys != 0)


def probe_small_table(probe_keys: torch.Tensor, table_keys: torch.Tensor,
                      table_vals: torch.Tensor):
    """Probe a small replicated table: (match_vals, match_cnts) aligned
    to the probe order, the largest matched value (unsigned) and the
    count of equal table keys for every live probe, (0, 0) otherwise.

    The table is sorted by (key, value) as one int64; a probe's matches
    are then one run, counted by two searches, its last value the
    largest."""
    packed = torch.sort((bias(table_keys).to(torch.int64) << 32)
                        | (table_vals.to(torch.int64) & _U32_MASK)).values
    tk = (packed >> 32).to(torch.int32)
    bk = bias(probe_keys)
    lo = torch.searchsorted(tk, bk)
    hi = torch.searchsorted(tk, bk, right=True)
    cnt = torch.where(probe_keys != 0, hi - lo, 0)
    last = packed.to(torch.int32)[(hi - 1).clamp(min=0)] if packed.numel() \
        else torch.zeros_like(probe_keys)
    mval = torch.where(cnt > 0, last, 0).to(torch.int32)
    return mval, cnt.to(torch.int32)


def extract_rows(keys: torch.Tensor, vals: torch.Tensor,
                 flags: torch.Tensor, cap: int):
    """The first `cap` flagged rows in input order, 0-padded to cap (the
    fixed-size replication buffer), and the count of flagged rows (a
    count past cap is the caller's overflow signal)."""
    idx = torch.nonzero(flags).view(-1)[:cap]
    out_k = torch.zeros(cap, dtype=keys.dtype, device=keys.device)
    out_v = torch.zeros(cap, dtype=vals.dtype, device=vals.device)
    out_k[: idx.shape[0]] = keys[idx]
    out_v[: idx.shape[0]] = vals[idx]
    return out_k, out_v, flags.sum(dtype=torch.int32)
