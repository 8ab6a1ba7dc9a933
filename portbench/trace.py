"""The traced slice: device activity from torch.profiler, reduced to kernels.

A traced run profiles one slice of its window (``trace_seconds`` of the
cell file, in its middle), between two points where the device is idle and
no engine step is in flight, so that every kernel of the slice's work, and
nothing else, is in the trace. Only CUDA activity is recorded (kernels,
copies, sets): the host side comes from the flight recorder's spans.

``Kernel`` rows are what the metric readers read; ``busy_s`` is the union
of their intervals.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    dur_us: float
    cat: str = "kernel"


def kernels_from_chrome(trace: dict) -> List[Kernel]:
    out = []
    for e in trace.get("traceEvents", ()):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            out.append(Kernel(e.get("name", ""), float(e["ts"]),
                              float(e.get("dur", 0.0)), e["cat"]))
    out.sort(key=lambda k: k.start_us)
    return out


def union_us(kernels: Sequence[Kernel]) -> float:
    """Microseconds in which at least one of ``kernels`` ran."""
    total, end = 0.0, None
    for k in sorted(kernels, key=lambda k: k.start_us):
        a, b = k.start_us, k.start_us + k.dur_us
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps_us(kernels: Sequence[Kernel]) -> List[Tuple[float, float]]:
    """Idle intervals (start, end) between the union's busy stretches."""
    out, end = [], None
    for k in sorted(kernels, key=lambda k: k.start_us):
        a, b = k.start_us, k.start_us + k.dur_us
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def top_ops(kernels: Sequence[Kernel], n: int = 10) -> List[list]:
    by: Dict[str, float] = {}
    for k in kernels:
        by[k.name] = by.get(k.name, 0.0) + k.dur_us
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]


def idle_breakdown(kernels: Sequence[Kernel], spans: Sequence[dict],
                   offset_us: float, n: int = 10,
                   outside: str = "host, outside the engine's spans"
                   ) -> List[list]:
    """The ``n`` longest idle gaps, each named by the host span that covers
    its middle (flight-recorder rows, wall-clock ``start_us``/``dur_us``;
    ``offset_us`` = wall clock minus trace clock), or ``outside``."""
    gaps = sorted(gaps_us(kernels), key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2 + offset_us
        name = outside
        best = None
        for sp in spans:
            s0 = sp["start_us"]
            if s0 <= mid <= s0 + sp["dur_us"] and (
                    best is None or sp["dur_us"] < best["dur_us"]):
                best = sp
        if best is not None:
            name = f"host in {best['name']}"
        out.append([name, (b - a) / 1e6])
    return out


class Slice:
    """Profile one slice: ``start()`` and ``stop()`` are called where the
    device is idle (the caller synchronises first). One marker kernel right
    after ``start`` ties the trace's clock to the wall clock."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None
        self.marker_wall_us = None
        self._buf = None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: the first start in
        a process initialises CUPTI."""
        self._buf = self.torch.zeros(1, device="cuda")
        p = self._make()
        p.start()
        self._buf.add_(1)
        self.torch.cuda.synchronize()
        p.stop()

    def _make(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof = self._make()
        self.prof.start()
        self.marker_wall_us = time.time() * 1e6
        self._buf.add_(1)
        self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> Tuple[List[Kernel], float]:
        """(the slice's device activity, the wall-minus-trace clock offset
        in us). The marker is taken out."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        ks = kernels_from_chrome(trace)
        offset = (self.marker_wall_us - ks[0].start_us) if ks else 0.0
        return ks[1:], offset
