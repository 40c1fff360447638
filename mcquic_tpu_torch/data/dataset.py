"""Image folders, tar shards, the random resized crop, and the sample
stream's shuffle and batching (counterpart of `mcquic_tpu/data/dataset.py`,
reference `mcquic/data/dataset.py:67-123` and the webdataset pipeline of
`mcquic/data/__init__.py:96-151`).

Images decode through the port's own codecs, chosen by the file's magic
bytes: PNG in every form (`data/png.py`), JPEG in every form PIL reads
(`data/jpeg.py`), BMP (`data/bmp.py`) and WebP (`data/webp.py`), each equal
to PIL's `convert("RGB")`. A file PIL cannot read (corrupt, truncated, or
of a kind libjpeg, libwebp or PIL refuses) decodes to None, as in the JAX
package.
"""
import glob
import logging
import random
import struct
import tarfile
import zlib
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mcquic_tpu_torch.data.bmp import MAGIC as BMP_MAGIC, decodeBmp
from mcquic_tpu_torch.data.jpeg import MAGIC as JPEG_MAGIC, UnsupportedJpeg, readJpeg
from mcquic_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE, decodePng
from mcquic_tpu_torch.data.webp import isWebp, readWebp

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
logger = logging.getLogger("mcquic_tpu_torch.data")


def listImages(root) -> List[Path]:
    return sorted(p for p in Path(root).rglob("*") if p.suffix.lower() in IMG_EXTENSIONS)


def isShardPattern(source) -> bool:
    """A glob or a `.tar` / `.tar.gz` path names tar shards, as in
    `mcquic_tpu/data/__init__.py:53-58`."""
    src = str(source)
    return any(ch in src for ch in "*?[") or src.endswith((".tar", ".tar.gz"))


def _decodeImage(data: bytes, name: str = "") -> Optional[np.ndarray]:
    """RGB uint8 [h, w, 3] of a PNG, JPEG, BMP or WebP file's bytes, by
    their magic; None for a file PIL cannot read either
    (`mcquic_tpu/data/dataset.py:27-34`). A valid JPEG of a kind the port
    does not read would raise `UnsupportedJpeg` naming `name`; no branch of
    the decoder raises it."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        try:
            return decodePng(data)
        except (ValueError, zlib.error, struct.error):
            return None
    try:
        if data.startswith(JPEG_MAGIC):
            return readJpeg(data, name)
        if data.startswith(BMP_MAGIC):
            return decodeBmp(data)
        if isWebp(data):
            return readWebp(data, name)
    except UnsupportedJpeg:
        raise
    except ValueError:
        return None
    return None


def readImage(path) -> np.ndarray:
    """RGB uint8 [h, w, 3] of a PNG, JPEG, BMP or WebP file; a file that does
    not decode raises (`mcquic_tpu/demo.py:151-154` and
    `mcquic_tpu/data/dataset.py:72-76` read what PIL reads)."""
    img = _decodeImage(Path(path).read_bytes(), str(path))
    if img is None:
        raise RuntimeError(f"Cannot decode {path}")
    return img


class BasicFolder:
    """The PNG, JPEG, BMP and WebP images under `root`, sorted by path, as
    uint8 [h, w, 3]; a file that does not decode raises, as in
    `mcquic_tpu/data/dataset.py:61-80`."""

    def __init__(self, root):
        self._files = listImages(root)
        if not self._files:
            raise FileNotFoundError(f"No images under {root}")

    def __len__(self):
        return len(self._files)

    def __getitem__(self, idx) -> np.ndarray:
        return readImage(self._files[idx])

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def shardMembers(shard: str):
    """(member name, bytes) of a shard's image files, in member order."""
    mode = "r:gz" if shard.endswith(".gz") else "r"
    with tarfile.open(shard, mode) as tf:
        for member in tf:
            if not member.isfile() or Path(member.name).suffix.lower() not in IMG_EXTENSIONS:
                continue
            yield member.name, tf.extractfile(member).read()


class TarShards:
    """The `{key}.{ext}` images of tar shards (the webdataset layout), as in
    `mcquic_tpu/data/dataset.py:83-120`: every shard the glob matches, in an
    order shuffled with `seed` plus the pass number, its images decoded in
    member order; a sample that does not decode and a shard that cannot be
    read are skipped. Host `hostId` of `hostCount` reads every
    `hostCount`-th shard of the sorted list from its own index on
    (`shards[hostId::hostCount]`, `mcquic_tpu/data/dataset.py:95`)."""

    def __init__(self, pattern: str, seed: int = 0, hostId: int = 0, hostCount: int = 1):
        shards = sorted(glob.glob(str(pattern)))
        if not shards:
            raise FileNotFoundError(f"No shards match {pattern}")
        self._shards = shards[hostId::hostCount]
        logger.debug("host %d of %d reads %d of %d shards: %s", hostId, hostCount,
                     len(self._shards), len(shards), [Path(p).name for p in self._shards])
        self._seed = seed
        self._epoch = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        shards = list(self._shards)
        random.Random(self._seed + self._epoch).shuffle(shards)
        self._epoch += 1
        for shard in shards:
            try:
                for name, data in shardMembers(shard):
                    img = _decodeImage(data, f"{shard}:{name}")
                    if img is not None:
                        yield img
            except (tarfile.TarError, OSError):
                continue


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
