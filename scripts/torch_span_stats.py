"""Per-tile window-span distribution of a workload and geometry in the
PyTorch/CUDA port (the counterpart of scripts/span_stats.py).

The two-class window geometry (JoinPlan.window + window_wide) needs the
span distribution to pick the narrow width; the engine's windows stage
measures only the max.  This runs just the sorts and the windows'
searches (no probe kernel: K1 runs inside the sorts) and prints span
quantiles and the wide-class population at candidate narrow widths.

Usage:
  python scripts/torch_span_stats.py [--zipf 1.0] [--tile 896]
      [--chunks 64] [--inner 16000000] [--outer 256000000] [--window 0]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from hash_join_codes_knl_tpu_torch.utils import bench as hb  # noqa: E402


def spans(args, dev):
    """(span of every probe tile in slots, tile, chunks, auto window)."""
    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.phj import (
        _merge_params,
        _merge_sort_probe,
        _merge_sort_side,
        _window_rows,
    )
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

    mode = "zipf" if args.zipf > 0 else (
        "ref" if args.outer <= args.inner else "uniform")
    inner, outer, _ = generate(seed=42, inner_tuples=args.inner,
                               outer_tuples=args.outer, mode=mode,
                               zipf=args.zipf)
    plan = dataclasses.replace(
        plan_join(args.inner, args.outer, tile=args.tile,
                  probe_chunks=args.chunks, device=dev),
        window=args.window or 0)
    tile, window, rows_total, cap = _merge_params(plan, args.inner,
                                                  args.outer)
    ik, iv, ok, ov = (u32_to_device(c, dev) for c in
                      (inner.keys, inner.vals, outer.keys, outer.vals))
    del inner, outer
    bhk, _ = _merge_sort_side(ik, iv, rows_total * 128, plan.factor)
    ohk, _ = _merge_sort_probe(ok, ov, cap, max(1, plan.probe_chunks),
                               plan.factor)
    # the windows' searches, spans kept (the engine reduces them to the
    # max); anchors clipped to the build side as span_stats.py does
    wrow, hi_row = _window_rows(bhk, ohk, tile, rows_total)
    wrow = wrow.clamp(0, rows_total - 1)
    span = ((hi_row - wrow) * 128).cpu().numpy()
    return span, tile, plan.probe_chunks, window


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--zipf", type=float, default=1.0)
    ap.add_argument("--tile", type=int, default=896)
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--inner", type=int, default=16_000_000)
    ap.add_argument("--outer", type=int, default=256_000_000)
    ap.add_argument("--window", type=int, default=0,
                    help="narrow-window candidates also get this value")
    hb.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = hb.entry_device(args.device)

    span, tile, chunks, window = spans(args, dev)
    n_tiles = len(span)
    print(f"geometry: tile={tile} chunks={chunks} auto_window={window} "
          f"n_tiles={n_tiles}")
    qs = [50, 75, 90, 95, 99, 99.5, 99.9, 100]
    vals = np.percentile(span, qs).astype(int)
    print("span quantiles:",
          " ".join(f"p{q}={v}" for q, v in zip(qs, vals)))
    for w_n in sorted({int(-(-v // 128) * 128) for v in vals[:-1]}):
        n_wide = int((span > w_n).sum())
        print(f"  narrow={w_n:>6}: wide tiles {n_wide} "
              f"({n_wide / n_tiles:.2%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
