"""Out-of-core joins on the PyTorch/CUDA port: relations that do not fit
device memory (examples/out_of_core.py's steps).

Two joins (tiny sizes here so the example runs anywhere; scale the
numbers on real hardware):

- stream_join: build side on the device, probe side stays in host
  RAM / np.memmap and streams through in chunks (checkpoint/resume via
  spill_dir).
- grace_join: NEITHER side needs to fit -- one out-of-core radix pass
  spills both relations to host partition files, then per-partition
  joins stream through (resumable in both phases).

python examples/torch_out_of_core.py [spill_dir] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

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
    ap.add_argument("spill_dir", nargs="?", default=None)
    add_device_arg(ap)
    args = ap.parse_args()
    dev = entry_device(args.device)
    spill = args.spill_dir or tempfile.mkdtemp()
    rng = np.random.default_rng(3)
    ni, no = 50_000, 400_000
    ik = np.unique(rng.integers(1, 2**32, ni * 2, dtype=np.uint32))[:ni]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = ik[rng.integers(0, ni, no)].astype(np.uint32)  # host-resident
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)

    sres = hjk.stream_join(ik, iv, ok, ov, chunk_rows=64_000,
                           spill_dir=f"{spill}/stream", device=dev)
    print(f"stream_join: {sres.join_tuples} tuples over "
          f"{len(sres.chunks)} chunks (resumed {sres.resumed_chunks})")

    gres = hjk.grace_join(ik, iv, ok, ov, f_bits=4, chunk_rows=100_000,
                          spill_dir=f"{spill}/grace", device=dev)
    print(f"grace_join: {gres.join_tuples} tuples over "
          f"{1 << gres.f_bits} partitions (reused {gres.reused_sides})")

    # a re-run over the same inputs resumes from the spills
    gres2 = hjk.grace_join(ik, iv, ok, ov, f_bits=4, chunk_rows=100_000,
                           spill_dir=f"{spill}/grace", device=dev)
    assert gres2.join_tuples == gres.join_tuples
    print(f"resume: reused {gres2.reused_sides}, "
          f"{gres2.resumed_partitions} partitions from the journal")


if __name__ == "__main__":
    main()
