"""K2's share of its roofline over the decompress half (kernels layer)."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "decompress", readers.K2, "k2")
