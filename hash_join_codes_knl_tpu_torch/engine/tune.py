"""Plan-time probe-chunk tuner.

Counterpart of ``hash_join_codes_knl_tpu/engine/tune.py``.  The merge
plan sorts the probe side as C independent chunks; the sort's cost over
(chunk count, row length) is erratic and shifts with the library and the
device, so a hand-tuned C rots.  This module times the probe-side sort
(the term that distinguishes chunk plans; the window probe is width-flat)
for a few candidate C on the card at plan time, picks the fastest, and
caches the verdict per (probe rows, tile, candidate set, torch version,
device name) in a JSON file, so the cost is paid once per geometry and
software/hardware combination.

The candidates are the JAX package's.  ``HJK_TUNE=0`` disables tuning,
``HJK_TUNE_CACHE`` names the cache file (by default the port's own
``.hjk_tune_torch.json`` at the repository root, never the JAX
package's).  Off the card the default comes back untimed, so CPU plans
stay equal to the JAX package's.  Running out of device memory while
timing also gives the default (uncached), and a cache file that cannot
be read or written is skipped; any other error raises.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..utils.bench import sync

DEFAULT_CANDIDATES = (48, 56, 64, 72)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cache_path() -> str:
    return os.environ.get(
        "HJK_TUNE_CACHE", os.path.join(_REPO_ROOT, ".hjk_tune_torch.json")
    )


def _load_cache(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _tuning_device(device):
    """The CUDA device to time on, or None off the card (None means the
    default device: the card where there is one)."""
    if device is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device)


def _key(outer_n: int, tile: int, cset: str, device) -> str:
    """The cache key of a verdict: (probe rows, tile, candidate set,
    torch version, device name)."""
    return (f"{outer_n}|{tile}|{cset}|{torch.__version__}|"
            f"{_device_name(device)}")


def _time_sort(outer_n: int, C: int, tile: int, reps: int, device) -> float:
    """Least seconds over `reps` runs of the merge plan's probe sort
    (engine/phj.py ``_merge_sort_probe``: K1 into (C, cap/C), each chunk
    sorted) on random columns of outer_n rows, each run between two
    synchronizes, after one warm-up.  The minimum, not the median: noise
    only ever adds time, and at reps=2 a median is the maximum.  The
    tuner times on the card; cached_sort_seconds also on the CPU."""
    from .config import DEFAULT_FACTOR
    from .phj import _merge_sort_probe

    quantum = tile * C
    cap = -(-outer_n // quantum) * quantum
    gen = torch.Generator(device=device)

    def columns(seed):
        gen.manual_seed(seed)
        return [torch.randint(-2**31, 2**31, (outer_n,), dtype=torch.int32,
                              device=device, generator=gen)
                for _ in range(2)]

    k, v = columns(0)
    _merge_sort_probe(k, v, cap, C, DEFAULT_FACTOR)  # warm-up
    ts = []
    for r in range(1, reps + 1):
        k, v = columns(r)
        sync(device)
        t0 = time.perf_counter()
        _merge_sort_probe(k, v, cap, C, DEFAULT_FACTOR)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def tuned_probe_chunks(
    outer_n: int,
    tile: int = 3072,
    default: int = 64,
    candidates=DEFAULT_CANDIDATES,
    reps: int = 2,
    cache_path: str | None = None,
    device=None,
) -> int:
    """The measured-best probe chunk count for this geometry on `device`
    (cached), or `default` off the card, with tuning disabled
    (HJK_TUNE=0) or out of device memory.  A single candidate comes back
    untimed."""
    if os.environ.get("HJK_TUNE", "1") == "0":
        return default
    if len(candidates) == 0:
        return default
    if len(candidates) == 1:
        return int(candidates[0])  # no choice to time
    dev = _tuning_device(device)
    if dev is None:
        return default
    # the candidate set is part of the key: plan_join narrows candidates
    # by its window-feasibility cap, and a verdict timed under a narrow
    # cap must not be reused where more C values are admissible
    cset = ",".join(str(C) for C in candidates)
    key = _key(outer_n, tile, cset, dev)
    path = cache_path or _cache_path()
    cache = _load_cache(path)
    if key in cache:
        return int(cache[key]["C"])
    try:
        times = {str(C): round(_time_sort(outer_n, C, tile, reps, dev), 4)
                 for C in candidates}
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return default
    best = int(min(times, key=lambda c: times[c]))
    # merge-on-write and an atomic replace: a concurrent tuner must
    # neither read a torn file nor lose its own fresh entry to this
    # process's stale snapshot
    cache = _load_cache(path)
    cache[key] = {"C": best, "times": times}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # an unwritable cache costs a re-timing next time, no more
    return best


def cached_sort_seconds(outer_n: int, tile: int, C: int, device,
                        reps: int = 2) -> tuple[float, str]:
    """(seconds, source) of the probe sort at chunk count C for this
    geometry on `device`: the time a tuner cache row for (outer_n, tile)
    under this torch and device recorded for C, else ``_time_sort`` now
    (least of `reps`; not cached).  The CPU is always timed."""
    device = torch.device(device)
    if device.type == "cuda":
        for key, row in _load_cache(_cache_path()).items():
            parts = key.split("|")
            if (len(parts) > 2 and str(C) in row["times"]
                    and key == _key(outer_n, tile, parts[2], device)):
                return float(row["times"][str(C)]), f"tuner cache {key}"
    return (_time_sort(outer_n, C, tile, reps, device),
            f"timed: _time_sort C={C}, least of {reps}")
