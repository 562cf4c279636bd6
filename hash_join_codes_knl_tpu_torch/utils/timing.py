"""Phase timing and structured metrics.

Counterpart of ``hash_join_codes_knl_tpu/utils/timing.py``.  The
reference stamps per-thread phase boundaries into times[8] / timelog[]
arrays (hj.h:39,69-70; npj.cpp:878-915).  Here a phase is one call: the
timer runs it, waits until the device has finished its work, and
records the wall time; `timeline` keeps the TIMELOG analog (monotonic
stamps per phase boundary).  Metrics are emitted as one JSON object
(tuples/s, per-stage seconds, bytes moved) instead of printf.
"""

from __future__ import annotations

import json
import time

import torch


class PhaseTimer:
    def __init__(self):
        self.phases: dict[str, float] = {}
        self.timeline: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def run(self, name: str, fn, *args, **kw):
        """Run fn, wait for the device, record the phase.

        CUDA launches return before the device has run them, so without
        the synchronize every phase's device time would fold into the
        next phase that waits (the fault the JAX timer's one-element
        host transfer fences against on the TPU).  The CPU needs no
        fence."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt
        self.timeline.append((name, time.perf_counter() - self._t0))
        return out

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    def metrics(self, **extra) -> dict:
        out = {f"{k}_s": round(v, 6) for k, v in self.phases.items()}
        out["total_s"] = round(self.total, 6)
        out.update(extra)
        return out

    def report(self, **extra) -> str:
        return json.dumps(self.metrics(**extra))
