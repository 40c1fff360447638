"""ImageNet-1k class ids and the class-conditional loader for stage-2
training (counterpart of `mcquic_tpu/data/imagenet_classes.py`, reference
`mcquic/data/imagenet_classes.py`).

A class id is the rank of a WordNet id among the sorted wnids: the sorted
order of the 1000 wnids is the canonical ImageNet-1k index, so, as in the
JAX package, no table is hard-coded; a folder with every class gets the
canonical ids, and the labels come from the folder names.

`getGenLoader` reads an imagenet-style folder (`root/<wnid>/*.JPEG`, PNG,
JPEG, BMP or WebP) or wnid-keyed tar shards (a glob, `.tar` or `.tar.gz`),
as the JAX package's does.
"""
import glob
import json
import random
import re
import tarfile
from pathlib import Path
from typing import Dict, List

import numpy as np

from mcquic_tpu_torch.data.dataset import (IMG_EXTENSIONS, _decodeImage,
                                           isShardPattern, randomResizedCrop, shardMembers,
                                           shuffled)

_WNID = re.compile(r"^n\d{8}$")


def classIndexFromWnids(wnids) -> Dict[str, int]:
    """Sorted wnid -> class id."""
    return {w: i for i, w in enumerate(sorted(set(wnids)))}


def folderClassIndex(root) -> Dict[str, int]:
    """The class index of an imagenet-style folder: its wnid-named
    directories, or every directory where none is named like a wnid."""
    root = Path(root)
    wnids = [d.name for d in root.iterdir() if d.is_dir() and _WNID.match(d.name)]
    if not wnids:
        wnids = [d.name for d in root.iterdir() if d.is_dir()]
    return classIndexFromWnids(wnids)


def classFiles(root) -> List[tuple]:
    """(path, class id) of every image under the class folders, in the JAX
    package's order: classes by id, files in directory-walk order."""
    root = Path(root)
    files = []
    for wnid, cls in folderClassIndex(root).items():
        for f in (root / wnid).rglob("*"):
            if f.suffix.lower() in IMG_EXTENSIONS:
                files.append((f, cls))
    return files


def shardClassIndex(pattern) -> Dict[str, int]:
    """The class index of wnid-keyed shards (`{wnid}_{n}.{ext}` members;
    `mcquic_tpu/data/imagenet_classes.py:41-68`): a `classes.json` beside the
    first shard (a list of wnids, or {wnid: label}) defines the class set;
    otherwise one pass over the shards' members collects it."""
    shards = sorted(glob.glob(str(pattern)))
    if not shards:
        raise FileNotFoundError(f"No shards match {pattern}")
    sidecar = Path(shards[0]).parent / "classes.json"
    if sidecar.exists():
        loaded = json.loads(sidecar.read_text())
        return classIndexFromWnids(list(loaded.keys()) if isinstance(loaded, dict) else loaded)
    wnids = set()
    for shard in shards:
        with tarfile.open(shard, "r:gz" if shard.endswith(".gz") else "r") as tf:
            for member in tf:
                wnid = Path(member.name).stem.split("_")[0]
                if _WNID.match(wnid):
                    wnids.add(wnid)
    if not wnids:
        raise FileNotFoundError(f"No wnid-keyed samples in {pattern}")
    return classIndexFromWnids(wnids)


def _genShardLoader(pattern, batchSize: int, cropSize: int, seed: int, hostId: int = 0,
                    hostCount: int = 1):
    """(image, label) batches from wnid-keyed tar shards
    (`mcquic_tpu/data/imagenet_classes.py:71-129`): epoch e shuffles the
    shards with `random.Random(seed + e)`, streams their members through the
    500-sample shuffle and crops with the same generator. Host `hostId` of
    `hostCount` reads `shards[hostId::hostCount]`; the class index comes from
    every shard."""
    index = shardClassIndex(pattern)
    allShards = sorted(glob.glob(str(pattern)))[hostId::hostCount]
    if not allShards:
        raise FileNotFoundError(f"No shards for host {hostId} in {pattern}")
    epochBox = [0]

    def loaderFn():
        epoch = epochBox[0]
        epochBox[0] += 1
        rng = random.Random(seed + epoch)
        shards = list(allShards)
        rng.shuffle(shards)

        def samples():
            for shard in shards:
                try:
                    for name, data in shardMembers(shard):
                        wnid = Path(name).stem.split("_")[0]
                        if wnid not in index:
                            continue
                        img = _decodeImage(data, f"{shard}:{name}")
                        if img is not None:
                            yield img, index[wnid]
                except (tarfile.TarError, OSError):
                    continue

        def gen():
            imgs, lbls = [], []
            for img, cls in shuffled(samples(), 500, seed=seed + epoch):
                if img.shape[0] < cropSize // 2 or img.shape[1] < cropSize // 2:
                    continue
                imgs.append(randomResizedCrop(rng, img, cropSize))
                lbls.append(cls)
                if len(imgs) == batchSize:
                    yield np.stack(imgs), np.asarray(lbls, np.int32)
                    imgs, lbls = [], []

        return gen()

    return loaderFn


def getGenLoader(root, batchSize: int, cropSize: int = 256, seed: int = 0, hostId: int = 0,
                 hostCount: int = 1):
    """A zero-argument callable returning a fresh epoch's iterator of
    (uint8 images [n, s, s, 3], int32 labels [n]) from class folders or
    wnid-keyed tar shards; epoch e shuffles and crops with
    `random.Random(seed + e)`, as the JAX loader does. Images under half the
    crop size and files that do not decode are skipped; a short last batch
    is dropped. Host `hostId` of `hostCount` reads every `hostCount`-th
    shard, or every `hostCount`-th file of the class folders, from its own
    index on (`mcquic_tpu/data/imagenet_classes.py:85-87`, `:154`)."""
    if isShardPattern(root):
        return _genShardLoader(str(root), batchSize, cropSize, seed, hostId, hostCount)
    files = classFiles(root)[hostId::hostCount]
    if not files:
        raise FileNotFoundError(f"No class-labeled images under {root}")
    epochBox = [0]

    def loaderFn():
        epoch = epochBox[0]
        epochBox[0] += 1
        rng = random.Random(seed + epoch)
        order = list(range(len(files)))
        rng.shuffle(order)

        def gen():
            imgs, lbls = [], []
            for idx in order:
                path, cls = files[idx]
                img = _decodeImage(path.read_bytes(), str(path))
                if img is None or img.shape[0] < cropSize // 2 or img.shape[1] < cropSize // 2:
                    continue
                imgs.append(randomResizedCrop(rng, img, cropSize))
                lbls.append(cls)
                if len(imgs) == batchSize:
                    yield np.stack(imgs), np.asarray(lbls, np.int32)
                    imgs, lbls = [], []

        return gen()

    return loaderFn
