"""What the readers of the program's own spans share.

The program records spans while `torch.profiler` records
(`mcquic_tpu_torch/utils/tracing.py`), on the clock the profiler stamps its
events with, so a span compares directly with `run.trace`'s phases, device
intervals and host operations (all in seconds here). A span belongs to the
phase its midpoint lies in: the two clocks agree to microseconds, and a
span begins and ends well inside its phase. Set-up's calls and the check
run with no profiler, so they leave no spans.

Each reader returns None where the run has nothing for it to read: no
trace, no such phase, no span of that name in it, or a program that
records no spans.
"""
import bisect
from typing import List, Optional, Sequence, Tuple

LAUNCHES = ("cudaLaunch", "cuLaunch")       # kernel launches: the runtime API, the low-level API
WAIT = "Command Buffer Full"                # CUPTI's record of a launch blocked on a full queue

Interval = Tuple[float, float]


def recorded() -> list:
    """The program's finished spans; none from a program without them."""
    try:
        from mcquic_tpu_torch.utils import tracing
    except ImportError:
        return []
    return tracing.spans()


def inPhase(run, name: str, phase: str) -> List[Tuple[int, int]]:
    """(start, end) in integer ns of the spans `name` in the phase, in order."""
    if run.trace is None or phase not in run.trace.phases:
        return []
    start, end = run.trace.window(phase)
    return sorted((s.start, s.end) for s in recorded()
                  if s.name == name and s.end is not None
                  and start <= (s.start + s.end) * 0.5e-9 <= end)


def seconds(spans: Sequence[Tuple[int, int]]) -> List[Interval]:
    return [(a * 1e-9, b * 1e-9) for a, b in spans]


def meanMs(run, name: str, phase: str) -> Optional[float]:
    """Mean ms per span: the spans' summed time over their number."""
    spans = inPhase(run, name, phase)
    if not spans:
        return None
    return 1e-6 * sum(b - a for a, b in spans) / len(spans)


def workMs(run, name: str, phase: str) -> Optional[float]:
    """Mean ms per span of the host's own work: the spans' summed time less
    what the driving thread spent in them blocked on a full launch queue,
    which is the device's back-pressure and not the host's work."""
    spans = inPhase(run, name, phase)
    if not spans:
        return None
    inside = union(seconds(spans))
    waits = union([(s, e) for n, s, e in run.trace.host if n.startswith(WAIT)])
    return 1e3 * (sum(b - a for a, b in inside) - overlap(inside, waits)) / len(spans)


def launchesPer(run, name: str, phase: str) -> Optional[float]:
    """Kernel launch calls on the driving thread inside the spans, per span."""
    spans = inPhase(run, name, phase)
    if not spans:
        return None
    starts = sorted(s for n, s, _ in run.trace.host if n.startswith(LAUNCHES))
    inside = sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
                 for a, b in union(seconds(spans)))
    return inside / len(spans)


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals as disjoint intervals in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(first: Sequence[Interval], second: Sequence[Interval]) -> float:
    """Seconds that two lists of disjoint intervals in order share."""
    total, i, j = 0.0, 0, 0
    while i < len(first) and j < len(second):
        total += max(0.0, min(first[i][1], second[j][1]) - max(first[i][0], second[j][0]))
        if first[i][1] < second[j][1]:
            i += 1
        else:
            j += 1
    return total


def idleInside(run, name: str, phase: str) -> Optional[float]:
    """% of the phase's device-idle seconds (the gaps between the union of
    its device intervals) that fall inside the spans."""
    spans = inPhase(run, name, phase)
    if not spans:
        return None
    start, end = run.trace.window(phase)
    busy = union([(max(s, start), min(e, end)) for _, s, e in run.trace.device
                  if e > start and s < end])
    edges = [start] + [t for interval in busy for t in interval] + [end]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    return 100.0 * overlap(gaps, union(seconds(spans))) / idle
