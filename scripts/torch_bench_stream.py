"""Out-of-core scale benchmark of the PyTorch/CUDA port: a host-resident
probe side streamed through one card (the counterpart of
scripts/bench_stream.py; engine/stream.py).

Workload: the 16M-row build side on the card (reference generator,
distinct keys), the probe side uniform picks FROM the build keys, made on
the device and copied to host RAM, so the exact join cardinality is the
probe count (every hit matches exactly once) at any scale.  --miss F
replaces a fraction of the probe keys by random ones; the exact count is
then taken by membership against the sorted build keys.

The report's h2d_gb is the bytes the stream copied to the card, as its
copy-stream events counted them (the probe rows' size on the CPU, where
nothing crosses); the copy rate goes to standard error.

Usage: python scripts/torch_bench_stream.py [--outer 1000000000]
       [--inner 16000000] [--chunk 64000000] [--spill-dir DIR] [--miss F]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from hash_join_codes_knl_tpu_torch.utils import bench as hb  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outer", type=int, default=1_000_000_000)
    ap.add_argument("--inner", type=int, default=16_000_000)
    ap.add_argument("--chunk", type=int, default=64_000_000)
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--miss", type=float, default=0.0,
                    help="fraction of probe rows that miss (random keys)")
    hb.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = hb.entry_device(args.device)

    from hash_join_codes_knl_tpu_torch.engine.stream import stream_join
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate

    inner, _, _ = generate(seed=42, inner_tuples=args.inner,
                           outer_tuples=args.inner, mode="ref")
    t0 = time.perf_counter()
    ok, ov = hb.picks(dev, inner.keys, args.outer, 7, 0x85EBCA77)
    want = args.outer
    if args.miss > 0:
        nm = int(args.miss * args.outer)
        # a random u32 still hits about inner/2^32 of the time, so the
        # exact count is membership against the sorted build keys
        rng = np.random.default_rng(7)
        ok[:nm] = rng.integers(1, 2**32, nm, dtype=np.uint32)
        ov[:nm] = ok[:nm] * np.uint32(0x85EBCA77)
        sk = np.sort(inner.keys)
        pos = np.searchsorted(sk, ok[:nm])
        pos[pos == len(sk)] = 0
        want = (args.outer - nm) + int((sk[pos] == ok[:nm]).sum())
        del sk, pos
    gen_s = time.perf_counter() - t0

    res = []
    dt = hb.fenced_seconds(lambda: res.append(stream_join(
        inner.keys, inner.vals, ok, ov, chunk_rows=args.chunk,
        spill_dir=args.spill_dir, device=dev)), dev)
    sres = res[0]
    ok_card = sres.join_tuples == want
    t = sres.transfer
    h2d_bytes = t.get("h2d_bytes", args.outer * 8)
    if t.get("h2d_ms"):
        print(f"h2d: {h2d_bytes / 1e9:.3f} GB in {t['h2d_ms']:.3f} ms of "
              f"copy-stream time = {h2d_bytes / t['h2d_ms'] / 1e6:.2f} GB/s "
              f"({hb.device_info(dev)})", file=sys.stderr)
    out = {
        "metric": f"stream_join_{args.inner//10**6}Mx{args.outer//10**6}M",
        "value": round(args.outer / dt, 1),
        "unit": "probe-tuples/s/chip",
        "seconds": round(dt, 4),
        "join_tuples": sres.join_tuples,
        "cardinality_exact": ok_card,
        "chunks": len(sres.chunks),
        "chunk_rows": args.chunk,
        "window": sres.plan.window,
        "h2d_gb": round(h2d_bytes / 1e9, 3),
        "resumed_chunks": sres.resumed_chunks,
        "hostgen_s": round(gen_s, 2),
        "spill": bool(args.spill_dir),
    }
    print(json.dumps(out))
    return 0 if ok_card else 1


if __name__ == "__main__":
    sys.exit(main())
