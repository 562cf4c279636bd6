"""Sweep the launch geometry of the PyTorch/CUDA port's two window
probes on one NVIDIA GPU, at the shapes of chip_smoke.py: K3's threads a
block and block order (chunk by chunk, or position by position over the
64 sorted chunks) on all 16M x 256M headline tiles, and K2's probes a
block on NPJ's 16M x 256M table and on the 1M x 8M merge plan.  Every
variant's output is held equal to the shipped geometry's.

    python3 scripts/torch_sweep_window_probes.py

Needs what chip_smoke.py needs (a CUDA device, nvcc, g++).  The shipped
values are ops/merge_probe_gather.py MAX_THREADS and ops/merge_probe.py
BLOCK_PROBES; this script only overrides them for its own run.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from hash_join_codes_knl_tpu_torch.engine.config import plan_join  # noqa: E402
from hash_join_codes_knl_tpu_torch.engine.npj import npj_join  # noqa: E402
from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp  # noqa: E402
from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg  # noqa: E402


def sweep_gather(args, chunks):
    shipped = mg.MAX_THREADS
    want = mg.merge_probe_gather(*args, chunks)
    for threads, c in ((shipped, chunks), (shipped, 1), (128, chunks),
                       (512, chunks), (1024, chunks)):
        mg.MAX_THREADS = threads
        cs._check_equal(f"K3 threads={threads} chunks={c}",
                        mg.merge_probe_gather(*args, c), want)
        ms = cs._median_ms(lambda: mg.merge_probe_gather(*args, c), 10)
        print(f"sweep: K3 all headline tiles, {threads} threads a block, "
              f"block order over {c} chunk(s): {ms:.4f} ms", flush=True)
    mg.MAX_THREADS = shipped


def sweep_dense(label, args, chunks=1):
    shipped = mp.BLOCK_PROBES
    want = mp.merge_probe(*args, chunks)
    for probes in (shipped, 2048, 4096, 32768):
        mp.BLOCK_PROBES = probes
        cs._check_equal(f"K2 {label} block probes {probes}",
                        mp.merge_probe(*args, chunks), want)
        ms = cs._median_ms(lambda: mp.merge_probe(*args, chunks), 10)
        geo = mp.window_table_geometry(args[5], args[4],
                                       args[0].shape[0] // args[4])
        print(f"sweep: K2 {label}, {geo.tiles_per_block} tiles a block "
              f"({probes} probes), {geo.threads} threads: {ms:.4f} ms",
              flush=True)
    mp.BLOCK_PROBES = shipped


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_sweep_window_probes: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    data, _ = cs._generate(*cs.HEADLINE, seed=42, mode="uniform")
    cols = cs._device_cols(data, dev)
    del data
    plan = plan_join(*cs.HEADLINE)
    bhk, bval, ohk, _, wrow, tile, window = cs._stages(cols, plan)
    sweep_gather((ohk, bhk, bval, wrow, tile, window), plan.probe_chunks)
    del bhk, bval, ohk, wrow
    torch.cuda.empty_cache()

    plan_n = npj_join(*cols)[-1]
    sweep_dense(f"NPJ table, tile {plan_n.tile} window {plan_n.window}",
                cs.npj_probe_inputs(cols, plan_n))
    del cols
    torch.cuda.empty_cache()
    data, _ = cs._generate(*cs.SMALL, seed=41, mode="uniform")
    plan = plan_join(*cs.SMALL)
    bhk, bval, ohk, _, wrow, tile, window = cs._stages(
        cs._device_cols(data, dev), plan)
    sweep_dense(f"1M x 8M merge plan, tile {tile} window {window}",
                (ohk, bhk, bval, wrow, tile, window))


if __name__ == "__main__":
    sys.exit(main())
