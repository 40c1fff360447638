"""The whole decompress half's share of the card's peak."""
from perfbench import readers


def read(run):
    return readers.mfu(run, "decompress")
