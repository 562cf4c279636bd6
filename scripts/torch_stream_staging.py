"""The host's copy rates on stream_join's staging path, on the card.

    python3 scripts/torch_stream_staging.py [--chunk ROWS]

stream_join (engine/stream.py) stages each probe chunk through a pinned
host buffer: the host copies the chunk's columns into it, then the copy
stream sends it to the card.  For one `chunk`-row uint32 column this
prints the card's name and power limit, then the rate of the host copy
into the pinned buffer, single-threaded (np.copyto) and with the
stream's own 8 copy threads (engine/stream.py ``_fill``), and the
pinned-to-device rate of that buffer (CUDA events).  Each host rate is
the best of three copies of fresh source rows, after one warm-up.
chip_smoke.py's out-of-core phase prints the stream's own transfer
split (copy-stream time, its overlap with compute, host fill seconds).

Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def host_rates(chunk: int, src: np.ndarray) -> str:
    from hash_join_codes_knl_tpu_torch.engine import stream

    pinned = torch.empty(chunk, dtype=torch.int32, pin_memory=True)
    dst = pinned.numpy().view(np.uint32)
    dev = torch.empty(chunk, dtype=torch.int32, device="cuda")
    gb = 4 * chunk / 1e9
    out = []
    with concurrent.futures.ThreadPoolExecutor(stream._FILL_THREADS) as pool:
        for label, fill in (("np.copyto", lambda s: np.copyto(dst, s)),
                            (f"_fill, {stream._FILL_THREADS} threads",
                             lambda s: stream._fill(pool, dst, s))):
            ts = []
            for i in range(4):
                s = src[i * chunk:(i + 1) * chunk]
                t0 = time.perf_counter()
                fill(s)
                ts.append(time.perf_counter() - t0)
            out.append(f"{label} {gb / min(ts[1:]):.2f} GB/s")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    dev.copy_(pinned, non_blocking=True)
    ev[0].record()
    for _ in range(4):
        dev.copy_(pinned, non_blocking=True)
    ev[1].record()
    ev[1].synchronize()
    out.append(f"pinned to device {4 * gb / ev[0].elapsed_time(ev[1]) * 1e3:.2f}"
               " GB/s")
    return "; ".join(out)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--chunk", type=int, default=64_000_000)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    src = np.random.default_rng(7).integers(0, 2**32, 4 * args.chunk,
                                            dtype=np.uint32)
    print(f"host rates, {args.chunk}-row column: "
          f"{host_rates(args.chunk, src)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
