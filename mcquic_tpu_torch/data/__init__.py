"""Evaluation data: a folder of images, batch 1, aligned crop (counterpart of
`mcquic_tpu/data/__init__.py::getValLoader` and
`mcquic_tpu/data/dataset.py::BasicFolder`, reference
`mcquic/data/__init__.py:154-170`).

The port decodes PNG only (`data/png.py`): torch, numpy and the standard
library have no JPEG, BMP or WebP decoder. Files with those suffixes are
listed as the JAX package lists them, then skipped with a warning, so a
folder that mixes formats is never evaluated silently on a subset.
"""
import logging
from pathlib import Path
from typing import Iterator, List

import numpy as np

from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.data.transforms import alignedCrop

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
logger = logging.getLogger("mcquic_tpu_torch.data")


def listImages(root) -> List[Path]:
    return sorted(p for p in Path(root).rglob("*") if p.suffix.lower() in IMG_EXTENSIONS)


class BasicFolder:
    """The PNG images under `root`, sorted by path, as uint8 [h, w, 3]."""

    def __init__(self, root):
        files = listImages(root)
        if not files:
            raise FileNotFoundError(f"No images under {root}")
        self._files = [p for p in files if p.suffix.lower() == ".png"]
        for p in files:
            if p.suffix.lower() != ".png":
                logger.warning("%s is not a PNG; this package decodes PNG only; skipped", p)

    def __len__(self):
        return len(self._files)

    def __getitem__(self, idx) -> np.ndarray:
        return readPng(self._files[idx])

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


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
