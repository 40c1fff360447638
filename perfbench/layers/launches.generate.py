"""Kernel launch calls on the driving thread inside `generator.sampleCodes`, per
call (generator layer)."""
from perfbench import spans


def read(run):
    return spans.launchesPer(run, "generator.sampleCodes", "generate")
