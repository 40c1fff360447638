"""Host ms per batch of `engine.ransEncode`, on compressMany's worker thread
(entropy coder layer)."""
from perfbench import spans


def read(run):
    return spans.meanMs(run, "engine.ransEncode", "compress")
