"""Host ms per batch of `engine.encodeDispatch` in compressMany (pad, upload,
enqueue the encode, start the download), less its waits on a full launch
queue: the host's own work (engine layer)."""
from perfbench import spans


def read(run):
    return spans.workMs(run, "engine.encodeDispatch", "compress")
