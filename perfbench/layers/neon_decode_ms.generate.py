"""Device ms per call of Neon's decode of the sampled codes, by CUDA events (models layer)."""
from perfbench import readers


def read(run):
    return readers.spanMs(run, "neonDecode")
