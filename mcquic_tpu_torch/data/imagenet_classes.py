"""ImageNet-1k class ids and the class-conditional loader for stage-2
training (counterpart of `mcquic_tpu/data/imagenet_classes.py`, reference
`mcquic/data/imagenet_classes.py`).

A class id is the rank of a WordNet id among the sorted wnids: the sorted
order of the 1000 wnids is the canonical ImageNet-1k index, so, as in the
JAX package, no table is hard-coded; a folder with every class gets the
canonical ids, and the labels come from the folder names.

`getGenLoader` reads an imagenet-style folder (`root/<wnid>/*.png`). The
port decodes PNG only (`data/png.py`), so tar shards and folders holding
JPEG (or any other non-PNG) images are refused, as `data/__init__.py::
checkTrainSet` refuses them for stage 1 (ROADMAP: JPEG shards).
"""
import random
import re
from pathlib import Path
from typing import Dict, List

import numpy as np

from mcquic_tpu_torch.data.dataset import IMG_EXTENSIONS, randomResizedCrop
from mcquic_tpu_torch.data.png import readPng

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


def getGenLoader(root, batchSize: int, cropSize: int = 256, seed: int = 0):
    """A zero-argument callable returning a fresh epoch's iterator of
    (uint8 images [n, s, s, 3], int32 labels [n]); epoch e shuffles the files
    and crops with `random.Random(seed + e)`, as the JAX loader does. Images
    under half the crop size are skipped; a short last batch is dropped."""
    src = str(root)
    if any(ch in src for ch in "*?[") or src.endswith((".tar", ".tar.gz")):
        raise ValueError(f"trainSet {src!r} names tar shards; this package reads class folders "
                         "of PNGs only (no JPEG decoder without PIL)")
    files = classFiles(root)
    if not files:
        raise FileNotFoundError(f"No class-labeled images under {root}")
    others = [f for f, _ in files if f.suffix.lower() != ".png"]
    if others:
        raise ValueError(f"trainSet {src!r} holds {len(others)} non-PNG images (e.g. {others[0]}); "
                         "this package decodes PNG only")
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
                img = readPng(path)
                if img.shape[0] < cropSize // 2 or img.shape[1] < cropSize // 2:
                    continue
                imgs.append(randomResizedCrop(rng, img, cropSize))
                lbls.append(cls)
                if len(imgs) == batchSize:
                    yield np.stack(imgs), np.asarray(lbls, np.int32)
                    imgs, lbls = [], []

        return gen()

    return loaderFn
