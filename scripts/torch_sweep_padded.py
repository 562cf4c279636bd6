"""Sweep the launch geometry of the PyTorch/CUDA port's two padded-path
kernels on one NVIDIA GPU, at the 16M x 256M shapes of chip_smoke.py:
the radix scatter's block size (pass 1 and the pass-2 batch of the
4096-way plan, whole call and scatter kernel alone) and the tile probe's
tiles per block (all tiles of the sort-mode and the radix layouts).
Every variant's output is held equal to the shipped geometry's.

    python3 scripts/torch_sweep_padded.py

Needs what chip_smoke.py needs (a CUDA device, nvcc, g++).  The shipped
values are ops/radix_partition.py SCATTER_THREADS and ops/probe.py
table_geometry; this script only overrides them for its own run.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from hash_join_codes_knl_tpu_torch.engine.phj import _scrambled  # noqa: E402
from hash_join_codes_knl_tpu_torch.ops import probe as pt  # noqa: E402
from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp  # noqa: E402


def sweep_scatter(label, args):
    shipped = rp.SCATTER_THREADS
    want = rp.radix_partition(*args)
    for threads in (shipped, 1024, 512, 256):
        rp.SCATTER_THREADS = threads
        cs._check_equal(f"{label} threads={threads}",
                        rp.radix_partition(*args), want)
        ms = cs._median_ms(lambda: rp.radix_partition(*args), 7)
        split = cs.radix_trace(args, f"{label} threads={threads}")
        print(f"sweep: {label} scatter threads {threads}: whole call "
              f"{ms:.4f} ms, scatter kernel {split['scatter']:.4f} ms",
              flush=True)
    rp.SCATTER_THREADS = shipped
    return want


def sweep_probe(label, lay, tile, shares):
    shipped = pt.table_geometry
    full = (lay["pk"], lay["tk"], lay["tv"], lay["tpid"], tile)
    want = pt.probe_tiles(*full)
    geo = shipped(lay["tk"].shape[1], tile, lay["tpid"].shape[0],
                  lay["tk"].shape[0])
    for tpb in (geo[4], *shares):
        pt.table_geometry = lambda *a, tpb=tpb: (*shipped(*a)[:4], tpb)
        cs._check_equal(f"{label} tiles per block {tpb}",
                        pt.probe_tiles(*full), want)
        ms = cs._median_ms(lambda: pt.probe_tiles(*full), 5)
        print(f"sweep: {label} probe, {geo[3]} threads, {geo[1]} entries, "
              f"{tpb} tiles a block: {ms:.4f} ms", flush=True)
    pt.table_geometry = shipped


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_padded: no CUDA device is available")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    data, _ = cs._generate(*cs.HEADLINE, seed=42, mode="uniform")
    cols = cs._device_cols(data, dev)
    del data
    plan = cs._radix_4096_plan()
    b1, b2 = plan.pass_bits

    hk, v = _scrambled(cols[2], cols[3], plan.factor)
    got = sweep_scatter("pass 1, 256M rows", (hk, v, b1))
    del hk, v
    sweep_scatter("pass-2 batch", (got[0], got[1], b2, b1, 0, 32768,
                                   1 << b1))
    del got
    hk, v = _scrambled(cols[0], cols[1], plan.factor)
    sweep_scatter("build side pass 1, 16M rows", (hk, v, b1))
    del hk, v
    torch.cuda.empty_cache()

    sort_plan = cs._sort_plan(*cs.HEADLINE)
    sweep_probe("sort mode", cs._padded_stages(*cols, sort_plan),
                sort_plan.tile, (1, 2, 4))
    torch.cuda.empty_cache()
    sweep_probe("radix 4096-way", cs._padded_stages(*cols, plan), 128,
                (128, 256, 512, 1024))


if __name__ == "__main__":
    sys.exit(main())
