"""Out-of-core build-side scale benchmark of the PyTorch/CUDA port: Grace
join on one card (the counterpart of scripts/bench_grace.py;
engine/grace.py) with neither relation held on the card whole.

Workload: the build side distinct nonzero u32 keys, the probe side
uniform picks FROM the build keys, both made on the device and copied to
host RAM, so the exact join cardinality equals the probe count at any
scale.

Default shape: 256M-row build x 1B-row probe, 64 partitions, phase-1
chunks of 48M rows.  The report's transfer_gb is bench_grace.py's
estimate of the bytes that cross to the card; its note carries the
card's host-to-device copy rate, measured here on a pinned buffer, and
the transfer floor that rate gives.

Usage: python scripts/torch_bench_grace.py [--build 256000000]
       [--probe 1000000000] [--f-bits 6] [--chunk 48000000]
       [--spill-dir DIR] [--device cpu]

The default spill dir is a FRESH temp dir (removed afterwards): a reused
dir would resume the phase-1 spills and the phase-2 journal and measure
seconds of checksum reads as if it joined 1B rows.  Pass --spill-dir to
study resume; the report carries reused_sides / resumed_partitions either
way, so a resumed run is never mistaken for a measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hash_join_codes_knl_tpu_torch.utils import bench as hb  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", type=int, default=256_000_000)
    ap.add_argument("--probe", type=int, default=1_000_000_000)
    ap.add_argument("--f-bits", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=48_000_000)
    ap.add_argument("--spill-dir", default=None)
    hb.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = hb.entry_device(args.device)
    spill_dir = args.spill_dir or tempfile.mkdtemp(prefix="grace_bench_")

    from hash_join_codes_knl_tpu_torch.engine.grace import grace_join

    t0 = time.perf_counter()
    ik, iv, ok, ov = hb.grace_data(dev, args.build, args.probe)
    gen_s = time.perf_counter() - t0

    res = []
    try:
        dt = hb.fenced_seconds(lambda: res.append(grace_join(
            ik, iv, ok, ov, f_bits=args.f_bits, chunk_rows=args.chunk,
            spill_dir=spill_dir, device=dev)), dev)
    finally:
        if args.spill_dir is None:
            shutil.rmtree(spill_dir, ignore_errors=True)
    gres = res[0]
    ok_card = gres.join_tuples == args.probe
    transfer_gb = (args.build + args.probe) * 8 * 2.2 / 1e9
    rate = hb.h2d_gbps(dev)
    if rate is None:
        note = "on the CPU: nothing crosses to a card"
    else:
        info = hb.device_info(dev)
        note = (f"H2D {rate:.2f} GB/s measured on a 1 GiB pinned copy "
                f"({info['name']}, {info['power_limit']}): a transfer "
                f"floor of {transfer_gb / rate:.3f} s")
    out = {
        "metric": f"grace_join_{args.build//10**6}Mx{args.probe//10**6}M",
        "value": round(args.probe / dt, 1),
        "unit": "probe-tuples/s/chip",
        "seconds": round(dt, 4),
        "join_tuples": gres.join_tuples,
        "cardinality_exact": ok_card,
        "partitions": 1 << gres.f_bits,
        "max_build_partition": max(m.build_rows for m in gres.partitions),
        "max_probe_partition": max(m.probe_rows for m in gres.partitions),
        "transfer_gb": round(transfer_gb, 1),
        "hostgen_s": round(gen_s, 2),
        "reused_sides": gres.reused_sides,
        "resumed_partitions": gres.resumed_partitions,
        "note": note,
    }
    print(json.dumps(out))
    return 0 if ok_card else 1


if __name__ == "__main__":
    sys.exit(main())
