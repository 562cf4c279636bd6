"""One rank of the port's multi-process distributed Grace join, launched
by torchrun (tests/test_torch_grace_dist_mp.py):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        --no-python python tests/torch_mp_grace_worker.py \\
        DATA_DIR SPILL_ROOT [--consumer] [--device cpu]

Brings up the process group from torchrun's environment
(parallel/distributed.process_group; gloo on the CPU), runs
grace_join_dist over the world on the workload saved in DATA_DIR
(ik.npy, iv.npy, ok.npy, ov.npy) at f_bits 4 and 1500 rows a superchunk,
and prints one line per rank, RESULT and a JSON object: the global total,
this rank's row digest (the 1:1 rows of the partitions it owns, with
--consumer), the reused sides, the resumed partitions, the partitions
this rank saw and the global per-partition counts.  A run that refuses
(a RuntimeError, such as a corrupt spill) prints REFUSED and a JSON
object with the message instead, waits for the other ranks and exits 3.
Imports no JAX."""

import argparse
import json
import os
import sys

import numpy as np


def _emit(tag: str, rec: dict) -> None:
    """One line on standard output in a single write.  The ranks share
    the stream, and print() writes the text and its newline apart when
    the stream writes through (PYTHONUNBUFFERED), so another rank's line
    could land between them; a pipe write of under 4096 bytes is not
    split."""
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), f"{tag} {json.dumps(rec)}\n".encode())


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("data_dir")
    p.add_argument("spill_root")
    p.add_argument("--consumer", action="store_true")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    import torch.distributed as dist

    from hash_join_codes_knl_tpu_torch.engine.oracle import multiset_digest
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        data_mesh,
        process_group,
    )
    from hash_join_codes_knl_tpu_torch.parallel.grace_dist import (
        grace_join_dist,
    )
    from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

    cols = [np.load(os.path.join(args.data_dir, f"{name}.npy"))
            for name in ("ik", "iv", "ok", "ov")]
    with process_group(device=args.device):
        mesh = data_mesh(device=args.device)
        rows, seen = [], []

        def collect(meta, res, raw_pk):
            assert len(res.build_counts) == 3
            m = res.match_cnts.cpu().numpy() == 1
            seen.append(meta.index)
            rows.append((raw_pk[m], to_numpy_u32(res.probe_vals)[m],
                         to_numpy_u32(res.match_vals)[m]))

        try:
            g = grace_join_dist(
                *cols, mesh, f_bits=4, chunk_rows=1500,
                spill_dir=args.spill_root,
                on_partition=collect if args.consumer else None,
                liveness_timeout_s=60.0)
        except RuntimeError as e:
            _emit("REFUSED", {"rank": mesh.rank, "error": str(e)})
            if dist.is_initialized():
                dist.barrier()  # every rank's line is out before any exits
            return 3
        cat = ([np.concatenate(c) for c in zip(*rows)] if rows
               else [np.zeros(0, np.uint32)] * 3)
        _emit("RESULT", {
            "rank": mesh.rank,
            "world": mesh.size,
            "total": g.join_tuples,
            "digest": list(multiset_digest(*cat)),
            "reused": g.reused_sides,
            "resumed": g.resumed_partitions,
            "parts_seen": sorted(seen),
            "meta_counts": [m.join_tuples for m in g.partitions],
        })
    return 0


if __name__ == "__main__":
    sys.exit(main())
