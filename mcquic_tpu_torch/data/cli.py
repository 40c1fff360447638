"""`python -m mcquic_tpu_torch dataset [-j N] [-G] IMAGES OUTPUT`: an image
folder to webdataset-style tar shards (counterpart of
`mcquic_tpu/data/cli.py`, reference `mcquic/data/cli.py`):
  * the filter: images of at least 512 x 512 whose mean total variation
    exceeds 64 (`_passesFilter`), checked on `jobs` threads;
  * `jobs` shard writers over contiguous chunks of the kept files, each
    into its `split###/` staging directory, every sample a `{key}.jpg`
    member at quality 95 (the port's encoder writes PIL's bytes) with keys
    `{start + i:09d}` numbered across the chunks, and with `-G` a `{key}.txt`
    caption from the file name;
  * gzip with its mtime pinned to 0, the staged shards renumbered into
    OUTPUT as `mcquic_DATA_%05d.tar.gz` (`_mergeSplits`), and
    `metadata.json` with the sample count.
For the same folder and `jobs`, the shards' tar bytes and `metadata.json`
equal the JAX writer's. Inputs are PNG, JPEG, BMP and WebP in every form
PIL reads; a file PIL cannot read is dropped, as the JAX writer drops it.
"""
import gzip
import io
import json
import logging
import shutil
import tarfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np

from mcquic_tpu_torch.data.dataset import _decodeImage, listImages
from mcquic_tpu_torch.data.jpeg import encodeJpeg

logger = logging.getLogger("mcquic_tpu_torch.data")

SHARD_PATTERN = "mcquic_DATA_%05d.tar.gz"
MAX_PER_SHARD = 100000
QUALITY = 95
MIN_SIZE = 512                 # the filter's least side, in pixels
MIN_TV = 64.0                  # the filter's total variation bound


def _passesFilter(img: np.ndarray) -> bool:
    """At least MIN_SIZE on both sides, and a total variation per pixel of
    the 4x-subsampled image above MIN_TV / 64 (`mcquic_tpu/data/cli.py:41-48`)."""
    if img.shape[0] < MIN_SIZE or img.shape[1] < MIN_SIZE:
        return False
    sub = img[::4, ::4]
    x = sub.astype(np.float32)
    tv = np.abs(np.diff(x, axis=0)).sum() + np.abs(np.diff(x, axis=1)).sum()
    return tv / (sub.shape[0] * sub.shape[1]) > MIN_TV / 64.0


def _validateOne(path: Path) -> Optional[Path]:
    """The path if its image decodes and passes the filter, else None."""
    img = _decodeImage(path.read_bytes(), str(path))
    return path if img is not None and _passesFilter(img) else None


class _ShardFile:
    """A tar.gz writer with gzip's mtime pinned to 0, so that the same inputs
    give the same bytes (tarfile does not close an external fileobj)."""

    def __init__(self, path: Path):
        self._gz = gzip.GzipFile(str(path), "wb", mtime=0)
        self._tar = tarfile.open(fileobj=self._gz, mode="w")

    def add(self, name: str, data: bytes):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        self._tar.addfile(info, io.BytesIO(data))

    def close(self):
        self._tar.close()
        self._gz.close()


def _writeSplit(rank: int, start: int, files: List[Path], outDir: Path, gen: bool) -> int:
    """One shard writer over its chunk of files (`mcquic_tpu/data/cli.py:
    83-120`): keys are `start` plus the file's index in the chunk."""
    splitDir = Path(outDir) / f"split{rank:03d}"
    shutil.rmtree(splitDir, ignore_errors=True)
    splitDir.mkdir(parents=True, exist_ok=True)
    shardIdx, inShard, written = 0, 0, 0
    shard = _ShardFile(splitDir / (SHARD_PATTERN % shardIdx))
    for i, path in enumerate(files):
        img = _decodeImage(path.read_bytes(), str(path))
        if img is None:
            continue
        key = f"{start + i:09d}"
        shard.add(f"{key}.jpg", encodeJpeg(img, QUALITY))
        if gen:
            shard.add(f"{key}.txt", path.stem.replace("_", " ").encode())
        written += 1
        inShard += 1
        if inShard >= MAX_PER_SHARD:
            shard.close()
            shardIdx += 1
            inShard = 0
            shard = _ShardFile(splitDir / (SHARD_PATTERN % shardIdx))
    shard.close()
    return written


def _mergeSplits(output: Path) -> int:
    """Renumber the staged shards into `output` and remove the staging
    directories (`mcquic_tpu/data/cli.py:123-132`)."""
    current = 0
    for split in sorted(Path(output).glob("split*")):
        for tar in sorted(split.glob("*.tar.gz")):
            shutil.move(str(tar), str(Path(output) / (SHARD_PATTERN % current)))
            current += 1
        shutil.rmtree(split)
    return current


def main(images, output, jobs: int = 1, gen: bool = False) -> int:
    """Write the shards; returns the number of samples."""
    jobs = max(int(jobs), 1)
    output = Path(output)
    output.mkdir(parents=True, exist_ok=True)
    files = listImages(images)
    logger.info("scanning %d candidate images", len(files))
    start = time.time()
    with ThreadPoolExecutor(jobs) as pool:
        kept = [f for f in pool.map(_validateOne, files) if f is not None]
    logger.info("%d/%d images pass the filter (%.1f img/s)", len(kept), len(files),
                len(files) / max(time.time() - start, 1e-9))

    # contiguous chunks; an empty chunk would stage an empty archive
    chunk = (len(kept) + jobs - 1) // jobs if kept else 0
    groups = [(r, r * chunk, kept[r * chunk:(r + 1) * chunk])
              for r in range(jobs) if kept[r * chunk:(r + 1) * chunk]]
    with ThreadPoolExecutor(max(len(groups), 1)) as pool:
        counts = list(pool.map(lambda g: _writeSplit(*g, output, gen), groups))
    total = int(sum(counts))
    shards = _mergeSplits(output)
    (output / "metadata.json").write_text(json.dumps({
        "count": total, "shards": shards, "imageText": bool(gen)}))
    logger.info("wrote %d samples into %d shard(s) at %s", total, shards, output)
    return total
