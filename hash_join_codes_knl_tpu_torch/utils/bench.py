"""Helpers of the bench harness (``bench_torch.py``,
``scripts/torch_bench_*.py``) and the examples: the device an entry point
runs on, fenced timing, the card's name and power limit, the host-to-card
copy rate, and the out-of-core benches' data, made on the device.

An entry point runs on the card unless its caller passes ``--device
cpu``; without a card and without that flag it exits 1 and says so.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from .hashing import mul_u32, to_numpy_u32, u32_to_device, u32_to_i32


def add_device_arg(ap) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or, asked for, on the "
                         "CPU (the kernels' plain versions)")


def entry_device(name: str = "cuda") -> torch.device:
    """The device of an entry point: the card unless `name` is "cpu".
    Without a card, unless asked for the CPU, prints why and exits 1."""
    if name != "cpu" and not torch.cuda.is_available():
        print("no CUDA device is available: this runs on the card; pass "
              "--device cpu to run the plain versions on the host",
              file=sys.stderr)
        raise SystemExit(1)
    return torch.device(name)


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def fenced_seconds(fn, device) -> float:
    """Host seconds of fn(), between two synchronizes."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def sync_run(fn, device, reps: int = 3) -> float:
    """fn(0) as the warm-up, then the median seconds of fn(1..reps), each
    run fenced (bench_configs.py's _sync_run)."""
    fn(0)
    return float(np.median([fenced_seconds(lambda r=r: fn(r), device)
                            for r in range(1, reps + 1)]))


def device_info(device) -> dict:
    """{"name", "power_limit"} of the card as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    name from torch and a null limit where nvidia-smi cannot answer);
    {"name": "cpu", "power_limit": None} on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        name, limit = (part.strip() for part in line.rsplit(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": torch.cuda.get_device_name(device),
                "power_limit": None}


def h2d_gbps(device, nbytes: int = 1 << 30, reps: int = 3) -> float | None:
    """Host-to-card copy rate in GB/s: the best of `reps` copies of a
    pinned host buffer of `nbytes`, timed by CUDA events.  None on the
    CPU (nothing crosses)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return nbytes / best / 1e6


def picks(dev, ik: np.ndarray, no: int, seed: int, factor: int):
    """`no` uniform picks from the build keys `ik`, made on `dev` in
    slices (the stream and Grace benches' probe side), values
    key * factor: host numpy uint32 (keys, values)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ik_d = u32_to_device(ik, dev)
    ok = np.empty(no, np.uint32)
    ov = np.empty(no, np.uint32)
    step = 100_000_000
    for s in range(0, no, step):
        n = min(step, no - s)
        k = ik_d[torch.randint(0, len(ik), (n,), device=dev, generator=g)]
        ok[s:s + n] = to_numpy_u32(k)
        ov[s:s + n] = to_numpy_u32(mul_u32(k, factor))
    return ok, ov


def grace_data(dev, ni: int, no: int):
    """The Grace bench's data, made on `dev`: ni distinct nonzero build
    keys (draws made unique, then a random permutation), values
    key * 0x9E3779B1; no probe rows picked from them, values
    key * 0x85EBCA77.  Host numpy uint32 columns (ik, iv, ok, ov)."""
    g = torch.Generator(device=dev).manual_seed(11)
    u = torch.unique(torch.randint(1, 2**32, (int(ni * 1.12),),
                                   device=dev, generator=g))
    if u.numel() < ni:
        raise AssertionError(f"grace: {u.numel()} distinct draws < {ni}")
    keys = u32_to_i32(u[torch.randperm(u.numel(), device=dev,
                                       generator=g)[:ni]])
    del u
    ik = to_numpy_u32(keys)
    iv = to_numpy_u32(mul_u32(keys, 0x9E3779B1))
    del keys
    ok, ov = picks(dev, ik, no, 12, 0x85EBCA77)
    return ik, iv, ok, ov
