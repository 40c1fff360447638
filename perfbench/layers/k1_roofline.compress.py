"""K1's share of its roofline over the compress half (kernels layer)."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "compress", readers.K1, "k1")
