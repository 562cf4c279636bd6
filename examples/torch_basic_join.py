"""Minimal end-to-end join on the PyTorch/CUDA port: generate, join,
materialize, verify (examples/basic_join.py's steps).

Runs on the card, or on the CPU with --device cpu.  Sizes are
overridable: python examples/torch_basic_join.py [inner] [outer]
[--device cpu]
"""

import argparse
import os
import sys

# the repository root, so the example runs from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import hash_join_codes_knl_tpu_torch as hjk  # noqa: E402
from hash_join_codes_knl_tpu_torch.utils.bench import (  # noqa: E402
    add_device_arg,
    entry_device,
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("inner", type=int, nargs="?", default=1 << 16)
    ap.add_argument("outer", type=int, nargs="?", default=1 << 18)
    add_device_arg(ap)
    args = ap.parse_args()
    dev = entry_device(args.device)

    # 'uniform' draws the probe side uniformly from the build keys
    # (mode='ref' is the bit-exact reference walk, outer <= inner only)
    inner, outer, meta = hjk.generate(
        seed=42, inner_tuples=args.inner, outer_tuples=args.outer,
        mode="uniform"
    )

    # join() auto-plans and re-plans on window overflow; the result is
    # the ALIGNED layout (one slot per probe row: match count + max val)
    res, plan = hjk.join(inner.keys, inner.vals, outer.keys, outer.vals,
                         device=dev)
    print(f"join_tuples={int(res.join_tuples)} plan={plan}")

    # compact matched rows to host columns (outer key, outer val, inner val)
    keys, vals, tabs = hjk.materialize(res)
    print(f"materialized {len(keys)} rows; first: "
          f"({keys[0]}, {vals[0]}, {tabs[0]})")

    # verify against the numpy golden join (multiset digest)
    want = hjk.multiset_digest(*hjk.join_oracle(
        inner.keys, inner.vals, outer.keys, outer.vals))
    got = hjk.multiset_digest(keys, vals, tabs)
    assert got == want, "digest mismatch vs oracle"
    print("verified against the golden oracle")


if __name__ == "__main__":
    main()
