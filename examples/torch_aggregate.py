"""Hash aggregates on the PyTorch/CUDA port: group-by over a relation and
over join output (examples/aggregate.py's steps).

The three aggregate surfaces (ops/aggregate.py):
  1. hash_aggregate            -- single-level sort-group-reduce
  2. hash_aggregate_chunked    -- two-level batched-chunk engine for
                                  low-cardinality groupings, with a
                                  COUNTED partial-capacity overflow
  3. aggregate_join_result     -- the BASELINE aggregate-on-join-output
                                  operator, straight off the aligned
                                  JoinResult (no materialization)

Runs on the card, or on the CPU with --device cpu.
python examples/torch_aggregate.py [rows] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

# the repository root, so the example runs from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import hash_join_codes_knl_tpu_torch as hjk  # noqa: E402
from hash_join_codes_knl_tpu_torch.utils.bench import (  # noqa: E402
    add_device_arg,
    entry_device,
)
from hash_join_codes_knl_tpu_torch.utils.hashing import (  # noqa: E402
    to_numpy_u32,
    u32_to_device,
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", type=int, nargs="?", default=200_000)
    add_device_arg(ap)
    args = ap.parse_args()
    dev = entry_device(args.device)
    n = args.rows
    rng = np.random.default_rng(11)

    # --- 1. group a raw (key, value) column pair: ~2K distinct groups
    keys = rng.integers(1, 2048, n, dtype=np.uint32)
    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    k_d, v_d = u32_to_device(keys, dev), u32_to_device(vals, dev)
    n_groups, gk, sums, counts = hjk.hash_aggregate(k_d, v_d)
    g = int(n_groups)
    gk, sums = to_numpy_u32(gk), to_numpy_u32(sums)
    counts = counts.cpu().numpy()
    print(f"single-level: {g} groups over {n} rows")

    # numpy cross-check on a few groups
    for key in gk[: min(g, 3)]:
        m = keys == key
        want = np.uint32(vals[m].sum())  # u32 wraparound, like the engine
        idx = int(np.flatnonzero(gk[:g] == key)[0])
        assert sums[idx] == want
        assert counts[idx] == m.sum()

    # --- 2. the two-level engine: same result, batched chunk sorts.
    # partial_cap bounds the per-chunk group slots; an overflow is a
    # COUNTED value and hash_aggregate_auto re-plans the budget from it
    # (one guaranteed-clean retry; single-level only at groups ~ rows)
    n2, gk2, sums2, counts2, overflow = hjk.hash_aggregate_chunked(
        k_d, v_d, chunks=16, partial_cap=1 << 16
    )
    assert int(overflow) == 0 and int(n2) == g
    assert np.array_equal(to_numpy_u32(gk2)[:g], gk[:g])
    assert np.array_equal(to_numpy_u32(sums2)[:g], sums[:g])
    print(f"two-level:    {int(n2)} groups, overflow={int(overflow)}")

    # a deliberately tiny cap: overflow is counted, auto falls back
    _, _, _, _, ovf = hjk.hash_aggregate_chunked(k_d, v_d, chunks=16,
                                                 partial_cap=256)
    ra = hjk.hash_aggregate_auto(k_d, v_d, chunks=16, partial_cap=256)
    assert int(ovf) > 0 and int(ra[0]) == g
    print(f"tiny cap:     overflow={int(ovf)} counted -> measured re-plan")

    # --- 2b. M:N join output aggregated ON DEVICE: the expansion is
    # streamed through expand_join blocks straight into partials -- it
    # never materializes in host memory
    base = np.unique(rng.integers(1, 2**32, 600, dtype=np.uint32))[:256]
    mn_ik = np.repeat(base, rng.integers(1, 5, 256)).astype(np.uint32)
    mn_iv = rng.integers(0, 2**32, len(mn_ik), dtype=np.uint32)
    mn_ok = base[rng.integers(0, 256, 4096)].astype(np.uint32)
    mn_ov = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    mn_res, _ = hjk.join(mn_ik, mn_iv, mn_ok, mn_ov, device=dev)
    nmn, mk, msums, mcounts = hjk.aggregate_join_result_expanded(
        mn_res, mn_ik, mn_iv, block_rows=2048)
    print(f"M:N streamed: {int(nmn)} groups over "
          f"{int(mcounts.sum(dtype=torch.int64))} expanded rows")

    # --- 3. aggregate over JOIN output: sum matched build values per
    # probe key, straight off the aligned result
    inner, outer, _ = hjk.generate(seed=7, inner_tuples=4096,
                                   outer_tuples=n, mode="uniform")
    res, _ = hjk.join(inner.keys, inner.vals, outer.keys, outer.vals,
                      device=dev)
    ng, jk, jsums, jcounts = hjk.aggregate_join_result(res)
    print(f"join output:  {int(ng)} groups from {int(res.join_tuples)} "
          "matched rows")
    assert int(jcounts.sum(dtype=torch.int64)) == int(res.join_tuples)
    print("OK")


if __name__ == "__main__":
    main()
