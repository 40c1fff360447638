"""Device idle share over the compress half."""
from perfbench import readers


def read(run):
    return readers.idleShare(run, "compress")
