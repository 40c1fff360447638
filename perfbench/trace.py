"""The profiler's trace of a window, reduced to what the per-layer readers need.

`Tracer` runs `torch.profiler` (CPU and CUDA activities) over the measured
window. `Trace` holds, once it stops:
  * the device's activities (kernels, copies, fills) as (name, start, end)
    in seconds on the profiler's clock;
  * the benchmark's own phases, the `perfbench.*` annotations it put
    around each part of the window;
  * the host's operations on the thread that drove the window, for naming
    what the host did while the device sat idle.
The raw events are read through `kineto_results.events()`, which is far
cheaper than building the profiler's event tree for a window of many
thousands of launches.
"""
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

PREFIX = "perfbench."


def _notWork(name: str) -> bool:
    """Device-side records that are not work on the device: the benchmark's
    own annotations as the device's timeline repeats them, runtime calls
    and synchronizations."""
    return name.startswith((PREFIX, "cuda")) or "Sync" in name


def _ns(event, which: str) -> int:
    method = getattr(event, f"{which}_ns", None)
    if method is not None:
        return int(method())
    return int(getattr(event, f"{which}_us")() * 1000)


class Trace:
    def __init__(self, device: List[Tuple[str, float, float]],
                 phases: Dict[str, Tuple[float, float]], host: List[Tuple[str, float, float]]):
        self.device = sorted(device, key=lambda e: e[1])
        self.phases = phases
        self.host = sorted(host, key=lambda e: e[1])

    @classmethod
    def fromProfiler(cls, prof) -> "Trace":
        events = prof.profiler.kineto_results.events()
        device, phases, host = [], {}, []
        threads = defaultdict(float)
        for e in events:
            name = e.name()
            start = _ns(e, "start") * 1e-9
            end = start + _ns(e, "duration") * 1e-9
            if str(e.device_type()).endswith("CUDA"):
                if not _notWork(name):
                    device.append((name, start, end))
            elif name.startswith(PREFIX):
                phases[name[len(PREFIX):]] = (start, end)
                threads[e.start_thread_id()] += end - start
            else:
                host.append((name, start, end, e.start_thread_id()))
        main = max(threads, key=threads.get) if threads else None
        return cls(device, phases, [(n, s, t) for n, s, t, tid in host if tid == main])

    def window(self, phase: Optional[str] = None) -> Tuple[float, float]:
        """A phase's (start, end), or the span of all phases."""
        if phase is not None:
            return self.phases[phase]
        spans = list(self.phases.values())
        return min(s for s, _ in spans), max(e for _, e in spans)

    def _clipped(self, start: float, end: float, match=None) -> np.ndarray:
        rows = [(max(s, start), min(e, end)) for n, s, e in self.device
                if e > start and s < end and (match is None or match(n))]
        return np.asarray(rows, np.float64).reshape(-1, 2)

    def busy(self, phase: Optional[str] = None) -> float:
        """Seconds of the window in which anything ran on the device: the
        union of its activities' intervals, so that work on two streams at
        once counts once."""
        start, end = self.window(phase)
        rows = self._clipped(start, end)
        total, reach = 0.0, start
        for s, e in rows[np.argsort(rows[:, 0])] if len(rows) else []:
            if e > reach:
                total += e - max(s, reach)
                reach = e
        return total

    def kernelSeconds(self, names, phase: Optional[str] = None) -> Tuple[float, int]:
        """(summed device seconds, launches) of the activities whose name
        contains one of `names`, inside the window."""
        start, end = self.window(phase)
        rows = self._clipped(start, end, lambda n: any(word in n for word in names))
        return float((rows[:, 1] - rows[:, 0]).sum()), len(rows)

    def topOps(self, count: int = 10, phase: Optional[str] = None) -> List[List]:
        start, end = self.window(phase)
        totals = defaultdict(float)
        for n, s, e in self.device:
            if e > start and s < end:
                totals[n] += min(e, end) - max(s, start)
        return [[n[:200], t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]

    def idleGaps(self, count: int = 10, phase: Optional[str] = None) -> List[List]:
        """Idle seconds of the device, summed by what the host was doing in
        the middle of each gap (its innermost operation on the driving
        thread, found by one sweep over the nested operations); the `count`
        largest."""
        start, end = self.window(phase)
        rows = self._clipped(start, end)
        rows = rows[np.argsort(rows[:, 0])] if len(rows) else rows
        gaps, reach = [], start
        for s, e in rows:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        if end > reach:
            gaps.append((reach, end))
        totals, stack, i = defaultdict(float), [], 0
        for s, e in gaps:                       # in time order, as are the host's operations
            t = (s + e) / 2
            while i < len(self.host) and self.host[i][1] <= t:
                while stack and stack[-1][2] < self.host[i][1]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][2] < t:
                stack.pop()
            totals[stack[-1][0] if stack else "host: Python between operations"] += e - s
        return [[n[:200], t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:count]]


class Tracer:
    """`torch.profiler` over the window, with CPU and CUDA activities."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def trace(self) -> Trace:
        return Trace.fromProfiler(self._prof)
