"""Data loaders (counterpart of `mcquic_tpu/data/__init__.py`, reference
`mcquic/data/__init__.py`):
  * `getTrainLoader` (`:42-67`): tar shards (a glob, a `.tar` or a
    `.tar.gz` path) or a folder of PNG and JPEG images, shuffled through a
    bounded buffer, random-resized-cropped to the crop size, batched; yields
    uint8 NHWC numpy batches through a background prefetch thread (the
    augmentation runs on the device, `data/augment.py`).
  * `getValLoader` (`:70-89`): a folder, batch 1, aligned crop.

The port reads PNG, JPEG, BMP and WebP (`data/dataset.py`), every form the
JAX package reads through PIL.
"""
import logging
import queue
import random
import threading
from typing import Iterable, Iterator

from mcquic_tpu_torch.data.dataset import (BasicFolder, TarShards, batched,
                                           isShardPattern, listImages, randomResizedCrop,
                                           shuffled)
from mcquic_tpu_torch.data.transforms import alignedCrop

__all__ = ["BasicFolder", "TarShards", "listImages", "prefetched", "getTrainLoader",
           "getValLoader"]
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


def getTrainLoader(pattern, batchSize: int, cropSize: int = 512, seed: int = 0,
                   shuffleBuffer: int = 500, prefetch: int = 4, hostId: int = 0,
                   hostCount: int = 1):
    """A zero-argument callable returning a fresh epoch's iterator of uint8
    [batchSize, cropSize, cropSize, 3] batches; epoch e shuffles the shards
    and the samples and crops with seed + e. Host `hostId` of `hostCount`
    reads its share of the tar shards (`TarShards`); a folder is read whole
    on every host with the same seed, as the JAX loader reads it
    (`mcquic_tpu/data/__init__.py:55-57`)."""
    src = str(pattern)
    epochBox = [0]

    def loaderFn():
        epoch = epochBox[0]
        epochBox[0] += 1
        rng = random.Random(seed + epoch)

        def samples():
            source = (TarShards(src, seed=seed + epoch, hostId=hostId, hostCount=hostCount)
                      if isShardPattern(src) else BasicFolder(src))
            for img in shuffled(iter(source), shuffleBuffer, seed=seed + epoch):
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
