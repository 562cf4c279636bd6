"""Device time from torch.profiler: the device intervals of one call and
the length of their union (the busy time), for chip_smoke.py and
scripts/torch_profile_headline.py."""

from __future__ import annotations

import torch


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def device_intervals(fn, want=(), trace_path: str | None = None) -> list:
    """(kernel name, start us, end us) of every device interval of one
    fn() under torch.profiler, after one warm-up call; the trace must
    hold a kernel whose name contains each string of `want`.  With
    trace_path, the accepted trace is also written there (a Chrome
    trace, JSON)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    # now and then torch.profiler comes back with no device events, or
    # without one of the call's kernels; the call is traced again then,
    # and a third such trace fails
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
        if ks and all(any(w in name for name, _, _ in ks) for w in want):
            if trace_path:
                prof.export_chrome_trace(trace_path)
            return ks
        print(f"the profiler's trace missed device intervals ({len(ks)} "
              f"intervals, wanted {want}); tracing again", flush=True)
    raise AssertionError(f"three traces missed device intervals {want}")
