"""Device idle share over the decompress half."""
from perfbench import readers


def read(run):
    return readers.idleShare(run, "decompress")
