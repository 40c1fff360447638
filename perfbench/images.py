"""The benchmark's image inputs, all made from one photo of the repository.

`photo` decodes `assets/photo_768x512.png` (8-bit RGB, not interlaced) with
zlib and the five PNG row filters, so the inputs depend on no image
library. `variants` makes seeded images from it on the device, in a few large calls, and bring them to the host as uint8.
"""
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

PHOTO = Path(__file__).resolve().parent.parent / "assets" / "photo_768x512.png"


def _unfilter(raw: bytes, h: int, w: int, bpp: int = 3) -> np.ndarray:
    stride = w * bpp
    rows, prev, pos = [], [0] * stride, 0
    for _ in range(h):
        kind, line = raw[pos], raw[pos + 1:pos + 1 + stride]
        pos += 1 + stride
        cur = [0] * stride
        for x in range(stride):
            a = cur[x - bpp] if x >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = prev[x]
            elif kind == 3:
                pred = (a + prev[x]) >> 1
            elif kind == 4:
                b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                raise ValueError(f"PNG filter {kind}")
            cur[x] = (line[x] + pred) & 255
        rows.append(cur)
        prev = cur
    return np.asarray(rows, np.uint8).reshape(h, w, bpp)


def readPng(path=PHOTO) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG -> uint8 [h, w, 3]."""
    data = Path(path).read_bytes()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if (depth, colour, interlace) != (8, 2, 0):
                raise ValueError("only 8-bit RGB PNGs without interlace are read")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    return _unfilter(zlib.decompress(idat), h, w)


def _finish(x: torch.Tensor, gain: torch.Tensor, noise: torch.Tensor) -> np.ndarray:
    """[n, h, w, 3] float in [0, 255] -> gain, Gaussian noise, uint8 on the host."""
    x = x * gain.view(-1, 1, 1, 1) + noise
    return x.round_().clamp_(0, 255).to(torch.uint8).cpu().numpy()


def variants(photo: np.ndarray, count: int, seed: int, device, sigma: float = 2.0,
             gains=(0.8, 1.2)) -> np.ndarray:
    """`count` images of the photo's size: seeded horizontal and vertical
    flips, circular shifts, a gain in `gains` and Gaussian noise of `sigma`
    levels -> uint8 [count, h, w, 3]."""
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.from_numpy(photo).to(device).float()
    h, w, _ = base.shape
    draws = torch.rand((count, 3), generator=g, device=device).cpu().numpy()
    shifts = torch.randint(0, h * w, (count,), generator=g, device=device).cpu().numpy()
    images = []
    for (fh, fv, _), s in zip(draws, shifts):
        x = base.flip(1) if fh < 0.5 else base
        x = x.flip(0) if fv < 0.5 else x
        images.append(torch.roll(x, (int(s) // w, int(s) % w), (0, 1)))
    gain = gains[0] + (gains[1] - gains[0]) * torch.from_numpy(draws[:, 2]).to(device).float()
    noise = torch.randn((count, h, w, 3), generator=g, device=device) * sigma
    return _finish(torch.stack(images), gain, noise)

