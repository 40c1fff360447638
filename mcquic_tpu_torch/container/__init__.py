"""`.mcq` container (counterpart of `mcquic_tpu/container/__init__.py`,
reference `mcquic/utils/specification.py:22-183`).

The file is one msgpack map `{fileHeader: {qp, version, codeSize: {m,
heights, widths, k}, imageSize: {height, width, channel}}, contents:
[bytes per level]}`, written with the pure-Python subset in
`container/msgpack.py`, so files cross between this package, the JAX
package and the reference byte for byte.
"""
from dataclasses import dataclass
from typing import List

from mcquic_tpu_torch.container import msgpack
from mcquic_tpu_torch.utils import versionCheck


@dataclass
class ImageSize:
    height: int
    width: int
    channel: int

    @property
    def Pixels(self) -> int:
        return self.height * self.width

    def __str__(self) -> str:
        return f"[{self.width}x{self.height}, {self.channel}]"


@dataclass
class CodeSize:
    """Per-level m / h / w / k lists."""
    m: List[int]
    heights: List[int]
    widths: List[int]
    k: List[int]

    def __str__(self) -> str:
        sequence = ", ".join(f"[{w}x{h}, {k}]x{m}"
                             for h, w, k, m in zip(self.heights, self.widths, self.k, self.m))
        return f"{self.m} code-groups: {sequence}"


@dataclass(init=False)
class FileHeader:
    qp: str
    version: str
    codeSize: CodeSize
    imageSize: ImageSize

    def __init__(self, version: str, qp: str, codeSize: CodeSize, imageSize: ImageSize):
        versionCheck(version)
        self.qp = qp
        self.version = version
        self.codeSize = codeSize
        self.imageSize = imageSize

    @property
    def QuantizationParameter(self) -> str:
        return str(self.qp)

    @property
    def CodeSize(self) -> CodeSize:
        return self.codeSize

    @property
    def ImageSize(self) -> ImageSize:
        return self.imageSize

    def __str__(self) -> str:
        return (f"\n    Version    : {self.version}"
                f"\n    QP         : {self.QuantizationParameter}"
                f"\n    Image size : {self.ImageSize}"
                f"\n    Code size  : {self.CodeSize}")


def _headerToDict(h: FileHeader) -> dict:
    return {
        "qp": h.qp,
        "version": h.version,
        "codeSize": {"m": list(h.codeSize.m), "heights": list(h.codeSize.heights),
                     "widths": list(h.codeSize.widths), "k": list(h.codeSize.k)},
        "imageSize": {"height": h.imageSize.height, "width": h.imageSize.width,
                      "channel": h.imageSize.channel},
    }


def _headerFromDict(d: dict) -> FileHeader:
    cs, ims = d["codeSize"], d["imageSize"]
    return FileHeader(version=d["version"], qp=d["qp"],
                      codeSize=CodeSize(list(cs["m"]), list(cs["heights"]),
                                        list(cs["widths"]), list(cs["k"])),
                      imageSize=ImageSize(ims["height"], ims["width"], ims["channel"]))


@dataclass
class File:
    """Header + per-level rANS binaries."""
    fileHeader: FileHeader
    contents: List[bytes]

    @property
    def FileHeader(self) -> FileHeader:
        return self.fileHeader

    @property
    def Content(self) -> List[bytes]:
        return self.contents

    def serialize(self) -> bytes:
        return msgpack.packb({"fileHeader": _headerToDict(self.fileHeader),
                              "contents": list(self.contents)})

    @staticmethod
    def deserialize(data: bytes) -> "File":
        payload = msgpack.unpackb(data)
        return File(_headerFromDict(payload["fileHeader"]),
                    [bytes(c) for c in payload["contents"]])

    @property
    def BPP(self) -> float:
        return sum(len(x) for x in self.contents) * 8 / self.FileHeader.ImageSize.Pixels

    def size(self, human: bool = False):
        """The binaries' bytes, or with `human` as text in B, KiB, ..."""
        total = sum(len(x) for x in self.contents)
        if not human:
            return total
        for unit in ("B", "KiB", "MiB", "GiB"):
            if total < 1024:
                return f"{total:.2f} {unit}"
            total /= 1024
        return f"{total:.2f} TiB"

    def __str__(self) -> str:
        return f"Header: {self.fileHeader}\nSize  : {self.size(True)}\nBPP   : {self.BPP:.4f}"
