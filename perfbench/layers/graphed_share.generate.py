"""% of the generate phase's sampling levels that ran from a CUDA graph: the
`replayed` counts over the `levels` counts of its `generator.sampleCodes`
spans (generator layer). None for a program whose spans carry no `levels`."""
from perfbench import spans


def read(run):
    if run.trace is None or "generate" not in run.trace.phases:
        return None
    start, end = run.trace.window("generate")
    counts = [s.counts for s in spans.recorded()
              if s.name == "generator.sampleCodes" and s.end is not None
              and start <= (s.start + s.end) * 0.5e-9 <= end
              and "levels" in getattr(s, "counts", {})]
    levels = sum(c["levels"] for c in counts)
    if not levels:
        return None
    return 100.0 * sum(c.get("replayed", 0) for c in counts) / levels
