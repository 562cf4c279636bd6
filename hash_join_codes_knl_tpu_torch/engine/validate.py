"""Oracle-free runtime invariant checks: the BG debug mode analog.

Counterpart of ``hash_join_codes_knl_tpu/engine/validate.py``.  The
reference's -DBG build re-checksums partition outputs and re-verifies
partition monotonicity after the scatter (phj.cpp:1034-1041,
1214-1229).  Given a JoinResult and the ORIGINAL probe relation, this
verifies, without any oracle join:

  1. key conservation: the multiset of live probe keys in the result
     equals the input key multiset (checked by u64 sum + count; the sort
     may only permute, never invent or drop tuples),
  2. pad hygiene: padding slots (key 0) carry zero match counts/values,
  3. match sanity: counts are non-negative and a match value implies a
     positive count,
  4. window monotonicity: the result's probe keys are hash-ordered
     within each sorted chunk (the partition-monotonicity re-check).

The checks run on the result's device; only their verdicts and the
statistics come to the host.  Raises ValueError with the JAX package's
diagnosis on the first violated invariant.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hashing import bias, mul_u32, u32_to_device

_U32_MASK = 0xFFFFFFFF


def _u64sum(x: torch.Tensor) -> int:
    """u64 wraparound sum of uint32 bits (exact in int64 below 2^31
    words)."""
    return int((x.to(torch.int64) & _U32_MASK).sum()) % 2**64


def validate_join_result(res, outer_keys, plan) -> dict:
    """Returns a small stats dict on success; raises ValueError on the
    first violated invariant.  `res` is a port JoinResult; `outer_keys`
    the probe relation's keys, numpy uint32 or an int32 bit tensor."""
    pk = res.probe_keys.reshape(-1)
    pv = res.probe_vals.reshape(-1)
    mv = res.match_vals.reshape(-1)
    mc = res.match_cnts.reshape(-1)
    if isinstance(outer_keys, torch.Tensor):
        in_keys = outer_keys.reshape(-1).to(pk.device)
    else:
        in_keys = u32_to_device(np.asarray(outer_keys).reshape(-1),
                                pk.device)

    live = pk != 0
    n_live = int(live.sum())
    n_in = int((in_keys != 0).sum())
    if n_live != n_in:
        raise ValueError(
            f"key conservation: {n_live} live result slots != "
            f"{n_in} input tuples"
        )
    got_sum, want_sum = _u64sum(pk), _u64sum(in_keys)
    if got_sum != want_sum:
        raise ValueError(
            f"key conservation: result key checksum {got_sum} != "
            f"input checksum {want_sum} (write.cpp:1635-1645 semantics)"
        )

    if bool((~live & ((mc != 0) | (mv != 0) | (pv != 0))).any()):
        raise ValueError("pad hygiene: padding slots carry matches/values")

    if bool((mc < 0).any()):
        raise ValueError("match sanity: negative match count")
    if bool(((mc == 0) & (mv != 0)).any()):
        raise ValueError("match sanity: match value without a match")

    # partition/window monotonicity: within each sorted probe chunk the
    # scrambled keys must be non-decreasing (pads are hk 0 and sort
    # first, so they never break monotonicity).  Irregular geometries
    # (result length not divisible by the chunk count -- a truncated or
    # re-laid-out result) cannot infer chunk boundaries; that case is
    # REPORTED in the stats instead of silently skipping the check.
    monotonicity = "n/a"
    if getattr(plan, "probe_impl", "merge").startswith("merge"):
        chunks = max(1, getattr(plan, "probe_chunks", 0))
        if len(pk) == 0 or len(pk) % chunks != 0:
            monotonicity = "skipped: irregular geometry " \
                f"({len(pk)} slots, {chunks} chunks)"
        else:
            h2 = bias(mul_u32(pk, plan.factor)).reshape(chunks, -1)
            if bool((h2[:, 1:] < h2[:, :-1]).any()):
                raise ValueError(
                    "monotonicity: probe layout not hash-ordered within "
                    "a sorted chunk"
                )
            monotonicity = "checked"

    return {
        "live_slots": n_live,
        "key_checksum": got_sum,
        "join_tuples": int(mc.sum(dtype=torch.int64)),
        "monotonicity": monotonicity,
    }
