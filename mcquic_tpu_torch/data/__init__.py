"""Data loaders (counterpart of `mcquic_tpu/data/__init__.py`, reference
`mcquic/data/__init__.py`):
  * `getTrainLoader` (`:42-67`): a folder of PNGs, shuffled through a
    bounded buffer, random-resized-cropped to the crop size, batched; yields
    uint8 NHWC numpy batches through a background prefetch thread (the
    augmentation runs on the device, `data/augment.py`).
  * `getValLoader` (`:70-89`): a folder, batch 1, aligned crop.

The port reads PNG only (`data/dataset.py`). A tar-shard pattern or a
training folder holding images of another format is refused with an error:
training on a silent subset would be a different run.
"""
import logging
import queue
import random
import threading
from pathlib import Path
from typing import Iterable, Iterator

from mcquic_tpu_torch.data.dataset import (BasicFolder, batched, listImages, randomResizedCrop,
                                           shuffled)
from mcquic_tpu_torch.data.transforms import alignedCrop

__all__ = ["BasicFolder", "listImages", "prefetched", "getTrainLoader", "getValLoader"]
logger = logging.getLogger("mcquic_tpu_torch.data")


def prefetched(gen: Iterable, depth: int = 4) -> Iterator:
    """Run the generator in a background thread with a bounded queue; an
    exception in the generator is raised to the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    failure = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except Exception as e:              # handed to the consumer, raised there
            failure.append(e)
        finally:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            break
        yield item
    if failure:
        raise failure[0]


def checkTrainSet(pattern) -> Path:
    """The training folder, after refusing what the port cannot read: tar
    shards (a glob or a .tar path) and folders with non-PNG images."""
    src = str(pattern)
    if any(ch in src for ch in "*?[") or src.endswith((".tar", ".tar.gz")):
        raise ValueError(f"trainSet {src!r} names tar shards; this package reads a folder of "
                         "PNGs only (no JPEG decoder without PIL)")
    others = [p for p in listImages(src) if p.suffix.lower() != ".png"]
    if others:
        raise ValueError(f"trainSet {src!r} holds {len(others)} non-PNG images (e.g. "
                         f"{others[0]}); this package decodes PNG only")
    return Path(src)


def getTrainLoader(pattern, batchSize: int, cropSize: int = 512, seed: int = 0,
                   shuffleBuffer: int = 500, prefetch: int = 4):
    """A zero-argument callable returning a fresh epoch's iterator of uint8
    [batchSize, cropSize, cropSize, 3] batches; epoch e shuffles and crops
    with seed + e."""
    root = checkTrainSet(pattern)
    epochBox = [0]

    def loaderFn():
        epoch = epochBox[0]
        epochBox[0] += 1
        rng = random.Random(seed + epoch)

        def samples():
            for img in shuffled(iter(BasicFolder(root)), shuffleBuffer, seed=seed + epoch):
                if img.shape[0] < 64 or img.shape[1] < 64:
                    continue
                yield randomResizedCrop(rng, img, cropSize)

        return prefetched(batched(samples(), batchSize), depth=prefetch)

    return loaderFn


def getValLoader(path, base: int = 256):
    """A zero-argument callable yielding (uint8 [1, h, w, 3], stem) per image,
    center-cropped to multiples of `base`. Images smaller than `base` would
    crop to nothing; they are skipped with a warning
    (`mcquic_tpu/data/__init__.py:70-89`)."""

    def gen():
        ds = BasicFolder(path)
        for i, img in enumerate(ds):
            if img.shape[0] < base or img.shape[1] < base:
                logger.warning("val image %s is smaller than the %dpx aligned crop; skipped",
                               ds._files[i], base)
                continue
            yield alignedCrop(img, base)[None], ds._files[i].stem

    return gen
