"""Host ms per call of the KV-cached sampling loop, ending in a synchronize (generator layer)."""
from perfbench import readers


def read(run):
    return readers.spanMs(run, "sampleCodes")
