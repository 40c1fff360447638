"""Image folders, the random resized crop, and the sample stream's shuffle
and batching (counterpart of `mcquic_tpu/data/dataset.py`, reference
`mcquic/data/dataset.py:67-123` and the webdataset pipeline of
`mcquic/data/__init__.py:96-151`).

The port decodes PNG only (`data/png.py`): torch, numpy and the standard
library have no JPEG, BMP or WebP decoder, so the JAX package's tar shards of
JPEGs are not read here (ROADMAP: JPEG shards).
"""
import logging
import random
from pathlib import Path
from typing import Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from mcquic_tpu_torch.data.png import readPng

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
logger = logging.getLogger("mcquic_tpu_torch.data")


def listImages(root) -> List[Path]:
    return sorted(p for p in Path(root).rglob("*") if p.suffix.lower() in IMG_EXTENSIONS)


class BasicFolder:
    """The PNG images under `root`, sorted by path, as uint8 [h, w, 3].
    Files of the other image suffixes are listed as the JAX package lists
    them, then skipped with a warning, so a folder that mixes formats is
    never read silently as a subset."""

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


def resizeBilinear(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [h, w, 3] -> uint8 [size, size, 3] by `F.interpolate` in fp32,
    bilinear with antialiasing, rounded to the nearest level.

    This is the filter PIL's `Image.BILINEAR` resize applies (a triangle
    whose support widens by the downscale factor), which the JAX package
    calls; PIL computes it in fixed point on uint8 and rounds at each of its
    two passes, so a pixel may differ from PIL's by one level."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=True)
    return torch.clamp(torch.round(y), 0, 255)[0].permute(1, 2, 0).to(torch.uint8).numpy()


def randomResizedCrop(rng: random.Random, img: np.ndarray, size: int,
                      scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """Torchvision-style RandomResizedCrop on numpy HWC (`dataset.py:37-58`):
    the same draws from `rng` give the same crop box as the JAX package;
    the resize is `resizeBilinear`."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        targetArea = area * rng.uniform(*scale)
        logRatio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*logRatio))
        cw = int(round(np.sqrt(targetArea * aspect)))
        ch = int(round(np.sqrt(targetArea / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            return resizeBilinear(img[top:top + ch, left:left + cw], size)
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return resizeBilinear(img[top:top + s, left:left + s], size)


def shuffled(iterable, bufferSize: int = 500, seed: int = 0):
    """Bounded-buffer shuffle (`dataset.py:123-135`)."""
    rng = random.Random(seed)
    buf = []
    for item in iterable:
        if len(buf) < bufferSize:
            buf.append(item)
            continue
        idx = rng.randrange(bufferSize)
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


def batched(iterable, batchSize: int):
    """Stacks of `batchSize` items; a short last batch is dropped."""
    buf = []
    for item in iterable:
        buf.append(item)
        if len(buf) == batchSize:
            yield np.stack(buf)
            buf = []
