"""Host ms per batch of `engine.ransDecode`, serial on decompressMany's thread
(entropy coder layer)."""
from perfbench import spans


def read(run):
    return spans.meanMs(run, "engine.ransDecode", "decompress")
