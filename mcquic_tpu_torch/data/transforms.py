"""Image alignment on the host, numpy NHWC (counterpart of
`mcquic_tpu/data/transforms.py`, reference `mcquic/data/transforms.py`)."""
from typing import Tuple

import numpy as np


def paddingAmounts(h: int, w: int, base: int = 128) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) padding up to multiples of base, centered."""
    hPad, wPad = (-h) % base, (-w) % base
    return hPad // 2, hPad - hPad // 2, wPad // 2, wPad - wPad // 2


def alignedPadding(x: np.ndarray, base: int = 128) -> np.ndarray:
    """Reflect-pad [n, h, w, c] (or [h, w, c]) to H/W multiples of base."""
    top, bottom, left, right = paddingAmounts(x.shape[-3], x.shape[-2], base)
    if top == bottom == left == right == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 3) + [(top, bottom), (left, right), (0, 0)]
    return np.pad(x, pad, mode="reflect")


def alignedCrop(x: np.ndarray, base: int = 128) -> np.ndarray:
    """Center-crop [..., h, w, c] down to H/W multiples of base."""
    h, w = x.shape[-3], x.shape[-2]
    hCrop, wCrop = h % base, w % base
    top, left = hCrop // 2, wCrop // 2
    return x[..., top:top + h - hCrop, left:left + w - wCrop, :]


def centerCropTo(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Center-crop padded output back to the original size."""
    top = (x.shape[-3] - h) // 2
    left = (x.shape[-2] - w) // 2
    return x[..., top:top + h, left:left + w, :]


def modelOutputToImage(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8, as the reference DeTransform (vision.py:135-146)
    and `mcquic_tpu/data/transforms.py:62-64`."""
    return np.clip(np.round((x * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)


def imageToModelInput(img: np.ndarray) -> np.ndarray:
    """uint8 HWC (or NHWC) image -> float32 in [-1, 1], as
    `mcquic_tpu/data/transforms.py:56-59`."""
    x = img.astype(np.float32) / 255.0
    return (x - 0.5) * 2.0
