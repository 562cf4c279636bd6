"""Time the sorted-window probes of one tree of this repository on one
NVIDIA GPU.  At the 16M x 256M uniform headline layout (tile 3072, window
15104, 64 chunks): K3 over all tiles, and K4 over the headline-sized tile
list of chip_smoke.py (every 16th tile, the engine's default wide_cap)
with its blocks over the plan's 64 chunks as the engine runs it, in list
order, and on the list sorted by chunk position.  At 16M x 256M Zipf
z=1.0: K4 on the two-class plan's wide pass as chip_smoke.py checks it.
K4 is held against its plain version and against K3's output; times are
CUDA-event medians and, for K4, device times of calls queued behind a
sleeping kernel (chip_smoke._queued_ms).

    python3 scripts/torch_ab_window_probes.py [TREE]

TREE (default: this checkout) is a copy of the repository, such as an
earlier commit unpacked with `git archive`: its port package and kernels
are measured, while this checkout's chip_smoke.py supplies the
measurement, so two trees run the same code around their kernels (a K4
without a block order takes none).  To compare two trees, call it once
per tree on one card, one command after another (parent, change, change,
parent).  Needs what
chip_smoke.py needs (a CUDA device, nvcc, g++).  Prints the card's name
and power limit, then one JSON line.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    if not mg.__file__.startswith(tree + os.sep):
        raise SystemExit(f"imported {mg.__file__}, not the tree {tree}")
    if "chunks" not in inspect.signature(
            mg.merge_probe_gather_indexed).parameters:
        k4 = mg.merge_probe_gather_indexed

        def k4_in_list_order(*a):
            return k4(*a[:9])

        k4_in_list_order.launches = 0
        mg.merge_probe_gather_indexed = k4_in_list_order
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_window_probes: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    data, _ = cs._generate(*cs.HEADLINE, seed=42, mode="uniform")
    cols = cs._device_cols(data, dev)
    del data
    plan = plan_join(*cs.HEADLINE)
    bhk, bval, ohk, _, wrow, tile, window = cs._stages(cols, plan)
    del cols
    out = measure(cs, mg, ohk, bhk, bval, wrow, tile, window,
                  plan.probe_chunks)
    del bhk, bval, ohk, wrow
    torch.cuda.empty_cache()
    cols, plan_z, _ = cs.phase_zipf_headline(dev)
    two, _, n_wide = cs._two_class_plan(cols, plan_z)
    zipf = cs._kernel_indexed(dev, cols, two, n_wide)
    out.update({f"k4_zipf_{k}": v for k, v in zipf.items()})
    print(json.dumps(dict(tree=tree, **out)), flush=True)


def measure(cs, mg, ohk, bhk, bval, wrow, tile: int, window: int,
            chunks: int) -> dict:
    """K3 over all tiles (CUDA events, median of 10); K4 over the
    headline-sized list with its blocks over `chunks` (checked and timed
    by chip_smoke), then in list order and on the list sorted by chunk
    position (both checked here against K3; CUDA events, median of 10,
    and queued behind a sleeping kernel)."""
    import torch

    full = (ohk, bhk, bval, wrow, tile, window, chunks)
    k3 = mg.merge_probe_gather(*full)
    out = dict(k3_all_tiles_ms=cs._median_ms(
        lambda: mg.merge_probe_gather(*full), 10))
    out.update(cs._kernel_indexed_headline(ohk, bhk, bval, wrow, tile,
                                           window, k3, chunks))
    n_tiles = ohk.shape[0] // tile
    per_chunk = -(-n_tiles // chunks)
    t = torch.arange(0, n_tiles, cs.K4_HEADLINE_STRIDE, device=ohk.device)
    by_position = t[torch.argsort((t % per_chunk) * chunks + t // per_chunk)]
    mv, mc = torch.zeros_like(ohk), torch.zeros_like(ohk)
    for name, ids in (("list_order", t), ("by_position", by_position)):
        ti, wc = ids.to(torch.int32), wrow[ids].contiguous()

        def k4():
            return mg.merge_probe_gather_indexed(ohk, bhk, bval, wc, ti, mv,
                                                 mc, tile, window)

        k4()
        cs._check_equal(f"K4 {name} vs K3",
                        [o.view(n_tiles, tile)[ids] for o in (mv, mc)],
                        [o.view(n_tiles, tile)[ids] for o in k3])
        out[f"k4_{name}_ms"] = cs._median_ms(k4, 10)
        out[f"k4_{name}_queued_ms"] = cs._queued_ms(k4)
    return out


if __name__ == "__main__":
    main()
