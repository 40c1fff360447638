"""K3's share of its roofline over the generation window (kernels layer)."""
from perfbench import readers


def read(run):
    return readers.roofline(run, "generate", readers.K3, "k3")
