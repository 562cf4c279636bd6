"""A torch.profiler trace of the PyTorch/CUDA port's headline join (the
counterpart of scripts/profile_headline.py).

Generates the 16M x 256M relations (``generate(seed=42)``), plans them,
runs one checked warm-up ``phj_join`` and one untimed steady-state run,
then traces exactly one steady-state run.  Prints the device time by
kernel, largest first, and the card's busy share between the traced
call's first and last kernel (the union of the device intervals over
their span).  The trace (Chrome JSON) goes to HJK_TRACE_DIR, by default
artifacts/trace_torch_headline/, which git ignores.

It reads device time, so it runs on the card only: without one it exits
1 and says so.

Env: HJK_AB_INNER/HJK_AB_OUTER (the sizes), HJK_TRACE_DIR.

    python scripts/torch_profile_headline.py
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hash_join_codes_knl_tpu_torch.utils import bench as hb  # noqa: E402


def main() -> int:
    dev = hb.entry_device("cuda")
    ni = int(os.environ.get("HJK_AB_INNER", 16_000_000))
    no = int(os.environ.get("HJK_AB_OUTER", 256_000_000))
    out_dir = os.environ.get(
        "HJK_TRACE_DIR", os.path.join(REPO, "artifacts",
                                      "trace_torch_headline"))

    from hash_join_codes_knl_tpu_torch.engine.config import plan_join
    from hash_join_codes_knl_tpu_torch.engine.phj import phj_join
    from hash_join_codes_knl_tpu_torch.relation import expected_join_tuples
    from hash_join_codes_knl_tpu_torch.relgen.generate import generate
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device
    from hash_join_codes_knl_tpu_torch.utils.trace import (
        device_intervals,
        union_us,
    )

    inner, outer, _ = generate(seed=42, inner_tuples=ni, outer_tuples=no,
                               mode="ref" if no <= ni else "uniform")
    cols = [u32_to_device(c, dev) for c in
            (inner.keys, inner.vals, outer.keys, outer.vals)]
    del inner, outer
    plan = plan_join(ni, no, device=dev)
    print(f"plan: tile={plan.tile} C={plan.probe_chunks} "
          f"({hb.device_info(dev)})", flush=True)

    def run():
        return phj_join(*cols, plan)

    t0 = time.perf_counter()
    got = int(run().join_tuples)
    print(f"warm run: {time.perf_counter() - t0:.4f} s", flush=True)
    if got != expected_join_tuples(ni, no):
        print(f"wrong cardinality: {got}", file=sys.stderr)
        return 1
    print(f"steady-state untraced: {hb.fenced_seconds(run, dev):.6f} s",
          flush=True)

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    t0 = time.perf_counter()
    # device_intervals runs one more untraced call first, then the traced
    ks = device_intervals(run, ["flat_to_rows_kernel"], trace_path=path)
    print(f"traced (with its warm-up call): "
          f"{time.perf_counter() - t0:.4f} s", flush=True)
    by_name = {}
    for name, a, b in ks:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    span = max(b for _, _, b in ks) - min(a for _, a, _ in ks)
    busy = union_us([(a, b) for _, a, b in ks])
    print(f"{len(ks)} device intervals, busy {busy / 1e3:.4f} of "
          f"{span / 1e3:.4f} ms between the first and last kernel "
          f"({busy / span:.4f})", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:10.4f} ms  {name[:100]}", flush=True)
    print(f"trace: {path} ({os.path.getsize(path)} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
