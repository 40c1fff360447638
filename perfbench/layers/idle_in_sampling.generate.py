"""% of the generation window's device-idle time that falls inside
`generator.sampleCodes` (device layer)."""
from perfbench import spans


def read(run):
    return spans.idleInside(run, "generator.sampleCodes", "generate")
