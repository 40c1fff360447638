"""Tiled coding of large images (counterpart of `mcquic_tpu/models/tiling.py`).

The image is reflect-padded to a grid of `tile` x `tile` tiles, the tiles
are coded as one batch, and the grid is recorded in the container:

    msgpack {grid: {rows, cols, tile, height, width}, version, qp,
             codeSize: {m, heights, widths, k}, contents: [[bytes per level] per tile]}

written with the port's msgpack subset, so a tiled `.mcq` is byte for byte
the JAX package's and restores in either package.
"""
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

import mcquic_tpu_torch
from mcquic_tpu_torch.container import CodeSize, FileHeader, ImageSize, msgpack
from mcquic_tpu_torch.data.transforms import imageToModelInput, modelOutputToImage
from mcquic_tpu_torch.utils import versionCheck


@dataclass
class TiledFile:
    rows: int
    cols: int
    tile: int
    height: int
    width: int
    binaries: List[List[bytes]]        # per tile, per level
    codeSize: CodeSize
    qp: str = "-1"

    def serialize(self) -> bytes:
        return msgpack.packb({
            "grid": {"rows": self.rows, "cols": self.cols, "tile": self.tile,
                     "height": self.height, "width": self.width},
            "version": mcquic_tpu_torch.__version__,
            "qp": self.qp,
            "codeSize": {"m": self.codeSize.m, "heights": self.codeSize.heights,
                         "widths": self.codeSize.widths, "k": self.codeSize.k},
            "contents": [list(levels) for levels in self.binaries],
        })

    @staticmethod
    def isTiled(data: bytes) -> bool:
        """Prefix sniff: a msgpack fixmap whose first key is the str 'grid'
        (`serialize` writes it first); a plain `.mcq` starts with
        'fileHeader'."""
        return len(data) > 6 and 0x80 <= data[0] <= 0x8F and data[1:6] == b"\xa4grid"

    @staticmethod
    def deserialize(data: bytes) -> "TiledFile":
        d = msgpack.unpackb(data)
        versionCheck(str(d.get("version", mcquic_tpu_torch.__version__)))
        g, cs = d["grid"], d["codeSize"]
        return TiledFile(rows=g["rows"], cols=g["cols"], tile=g["tile"],
                         height=g["height"], width=g["width"],
                         binaries=[[bytes(b) for b in levels] for levels in d["contents"]],
                         codeSize=CodeSize(m=list(cs["m"]), heights=list(cs["heights"]),
                                           widths=list(cs["widths"]), k=list(cs["k"])),
                         qp=str(d.get("qp", "-1")))

    @property
    def BPP(self) -> float:
        total = sum(len(b) for levels in self.binaries for b in levels)
        return total * 8 / (self.height * self.width)

    def __str__(self) -> str:
        total = sum(len(b) for levels in self.binaries for b in levels)
        return (f"Tiled {self.height}x{self.width} as {self.rows}x{self.cols} "
                f"of {self.tile}px (qp {self.qp})\n"
                f"Size  : {total} B\nBPP   : {self.BPP:.4f}")


def toTiles(img: np.ndarray, tile: int) -> Tuple[np.ndarray, int, int]:
    """uint8 HWC -> ([rows*cols, tile, tile, 3] row-major, rows, cols); the
    bottom and right edges are reflect-padded."""
    h, w = img.shape[:2]
    rows, cols = -(-h // tile), -(-w // tile)
    padded = np.pad(img, [(0, rows * tile - h), (0, cols * tile - w), (0, 0)], mode="reflect")
    tiles = padded.reshape(rows, tile, cols, tile, 3).transpose(0, 2, 1, 3, 4)
    return tiles.reshape(rows * cols, tile, tile, 3), rows, cols


def fromTiles(tiles: np.ndarray, rows: int, cols: int, h: int, w: int) -> np.ndarray:
    tile = tiles.shape[1]
    grid = tiles.reshape(rows, cols, tile, tile, 3).transpose(0, 2, 1, 3, 4)
    return grid.reshape(rows * tile, cols * tile, 3)[:h, :w]


def compressTiled(engine, img: np.ndarray, tile: int = 1024) -> TiledFile:
    """uint8 HWC image of any size -> TiledFile, the tiles coded as one batch."""
    h, w = img.shape[:2]
    tiles, rows, cols = toTiles(img, tile)
    _, binaries, headers = engine.compress(imageToModelInput(tiles))
    return TiledFile(rows=rows, cols=cols, tile=tile, height=h, width=w, binaries=binaries,
                     codeSize=headers[0].CodeSize, qp=str(engine.QuantizationParameter))


def decompressTiled(engine, tf: TiledFile) -> np.ndarray:
    """TiledFile -> uint8 HWC image."""
    headers = [FileHeader(mcquic_tpu_torch.__version__, engine.QuantizationParameter,
                          tf.codeSize, ImageSize(tf.tile, tf.tile, 3))
               for _ in tf.binaries]
    restored = engine.decompress(tf.binaries, headers)
    return modelOutputToImage(fromTiles(restored, tf.rows, tf.cols, tf.height, tf.width))
