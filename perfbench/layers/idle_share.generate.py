"""Device idle share over the generation window."""
from perfbench import readers


def read(run):
    return readers.idleShare(run, "generate")
