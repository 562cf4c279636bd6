"""Multi-rank joins on the PyTorch/CUDA port (CPRA exchange + local
joins; examples/multichip.py's steps).

Without torchrun it runs 8 gloo ranks as threads of this process, all
sharing one device (thread_meshes), so the full distributed path (owner
all-to-all, per-rank joins, skew handling) executes on one card or,
with --device cpu, on the host.  Under torchrun it runs one rank per
card (torchrun --nproc-per-node N examples/torch_multichip.py); rank 0
prints.

python examples/torch_multichip.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

# the repository root, so the example runs from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import hash_join_codes_knl_tpu_torch as hjk  # noqa: E402
from hash_join_codes_knl_tpu_torch.parallel.distributed import (  # noqa: E402
    process_group,
    run_ranks,
    thread_meshes,
)
from hash_join_codes_knl_tpu_torch.utils.bench import (  # noqa: E402
    add_device_arg,
    entry_device,
)

THREAD_RANKS = 8


def joins(mesh, ik, iv, ok, ov):
    """The three joins on one rank: (plain, tier-ratio, skewed) totals
    over the mesh."""
    def total(n):
        return int(mesh.all_sum([n])[0])

    # the owner exchange routes tuples by hash; each rank joins its share
    res, plan = hjk.cpra_join(ik, iv, ok, ov, mesh)
    plain = total(int(res.join_tuples))

    # tier-ratio placement (the reference's DDR/MCDRAM split as a
    # rank-group policy): 75% of traffic to one mesh half
    res_t, _ = hjk.cpra_join(ik, iv, ok, ov, mesh, slack=4.0,
                             tier_ratio=0.75)
    tier = total(int(res_t.join_tuples))

    # skewed probe side: heavy-hitter replication handles it
    ok_skew = ok.copy()
    ok_skew[: len(ok) // 4] = ik[0]
    light, heavy, _ = hjk.cpra_join(ik, iv, ok_skew, ov, mesh, skew=True)
    skew = total(int(light.join_tuples) + int(heavy[3].sum()))
    return plain, tier, skew


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    dev = entry_device(ap.parse_args().device)
    rng = np.random.default_rng(11)
    ni, no = 8192, 131072
    ik = np.unique(rng.integers(1, 2**32, ni * 2, dtype=np.uint32))[:ni]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = ik[rng.integers(0, ni, no)].astype(np.uint32)
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)

    with process_group(device=dev):
        mesh = hjk.data_mesh(device="cpu" if dev.type == "cpu" else None)
        if mesh.size > 1:  # torchrun: one rank per process
            plain, tier, skew = joins(mesh, ik, iv, ok, ov)
            size, lead = mesh.size, mesh.rank == 0
        else:
            meshes = thread_meshes(THREAD_RANKS, dev)
            plain, tier, skew = run_ranks(
                meshes, lambda m: joins(m, ik, iv, ok, ov))[0]
            size, lead = THREAD_RANKS, True
    if not lead:
        return
    print(f"cpra_join over {{'x': {size}}}: {plain} tuples")
    assert tier == plain
    print("tier-ratio run matches")
    print(f"skewed join (heavy-hitter replication): {skew} tuples")


if __name__ == "__main__":
    main()
