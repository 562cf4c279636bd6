"""M:N join expansion: the general-multiplicity output path.

Counterpart of ``hash_join_codes_knl_tpu/ops/expand.py``.  The aligned
probe keeps one matched payload per probe tuple; when build keys are not
unique (match_cnt > 1), the full cross-product rows are produced here: a
sorted-merge expansion with a fixed output capacity, the device
counterpart of the host oracle (engine/oracle.py).

Output rows are (probe_key, probe_val, build_val), null rows beyond the
true count.  Columns are int32 tensors holding uint32 bits
(utils/hashing.py); key 0 is the null key.  Plain torch: the JAX
package's expansion is plain jnp, with no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hashing import bias, u32_to_device


def greedy_blocks(counts, block_rows: int):
    """Split matched probe rows into consecutive blocks whose summed
    multiplicities fit `block_rows` each (host-side planning for the
    streamed expansion).  counts: int64 numpy array of per-row match
    multiplicities.  Yields (start, stop, block_total); a single row
    whose multiplicity exceeds block_rows gets its own block (callers
    auto-raise block_rows to counts.max() first, as materialize_expanded
    and aggregate_join_result_expanded do)."""
    ends = np.cumsum(counts)
    start, consumed = 0, 0
    while start < len(counts):
        stop = int(np.searchsorted(ends, consumed + block_rows,
                                   side="right"))
        stop = max(stop, start + 1)
        blk_total = int(ends[stop - 1] - consumed)
        yield start, stop, blk_total
        start, consumed = stop, int(ends[stop - 1])


def matched_rows(res):
    """(probe keys, probe vals, match counts as host int64) of the probe
    slots of a JoinResult with at least one match, in slot order: the
    input of the expansion.  The counts come to the host, where the
    expansion's blocks are planned."""
    mc = res.match_cnts.reshape(-1)
    m = mc > 0
    return (res.probe_keys.reshape(-1)[m], res.probe_vals.reshape(-1)[m],
            mc[m].cpu().numpy().astype(np.int64))


def build_side(keys, vals, device):
    """The build relation's columns as int32 bit tensors on `device`
    (numpy uint32 arrays are copied there)."""
    return tuple(c.to(device) if isinstance(c, torch.Tensor)
                 else u32_to_device(np.asarray(c), device)
                 for c in (keys, vals))


def expand_join(build_keys, build_vals, probe_keys, probe_vals,
                capacity: int):
    """Full M:N join into `capacity` output rows.

    Returns (count, out_keys, out_vals, out_tabs): count the true row
    count (a 0-d int64 tensor), then (capacity,) int32 columns whose rows
    past count are null.  count > capacity means the rows past capacity
    were cut: callers size capacity from the match counts, or re-plan on
    the reported count.  Slot for slot the JAX package's rows: probe
    order, then build rows of a key in their input order (a stable sort
    of the build side)."""
    dev = probe_keys.device
    n, nb = probe_keys.shape[0], build_keys.shape[0]
    s = torch.arange(capacity, device=dev)
    if n == 0 or nb == 0:
        z = torch.zeros(capacity, dtype=torch.int32, device=dev)
        return s.new_zeros(()), z, z.clone(), z.clone()
    # the null key sorts first under the biased order and never matches:
    # probe nulls get no rows below
    sk, order = torch.sort(bias(build_keys), stable=True)
    sv = build_vals[order]
    pb = bias(probe_keys)
    lo = torch.searchsorted(sk, pb)
    hi = torch.searchsorted(sk, pb, right=True)
    cnt = torch.where(probe_keys != 0, hi - lo, 0)
    ends = torch.cumsum(cnt, 0)
    total = ends[-1]
    # output slot s belongs to probe tuple i = first index with ends[i] > s
    idx = torch.searchsorted(ends, s, right=True).clamp(max=n - 1)
    valid = s < total
    bpos = (lo[idx] + s - (ends - cnt)[idx]).clamp(0, nb - 1)
    out_k = torch.where(valid, probe_keys[idx], 0)
    out_v = torch.where(valid, probe_vals[idx], 0)
    out_t = torch.where(valid, sv[bpos], 0)
    return total, out_k, out_v, out_t
