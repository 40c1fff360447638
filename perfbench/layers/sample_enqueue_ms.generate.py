"""Host ms per call of `generator.sampleCodes`: the level loop's enqueue, with no
synchronize (generator layer)."""
from perfbench import spans


def read(run):
    return spans.meanMs(run, "generator.sampleCodes", "generate")
