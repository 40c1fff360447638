"""Host ms per batch of `engine.decodeDispatch` in decompressMany (pack, upload,
enqueue the decode, start the download), less its waits on a full launch
queue: the host's own work (engine layer)."""
from perfbench import spans


def read(run):
    return spans.workMs(run, "engine.decodeDispatch", "decompress")
