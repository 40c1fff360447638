"""Validation meters (counterpart of `mcquic_tpu/validate/handlers.py`,
reference `mcquic/validate/handlers.py`): accumulate per-image results, and
report the running mean.

The image handlers take uint8 NHWC numpy batches and compute their metric
on `device` (the engine's, in `Validator`).
"""
from typing import Dict, List

import numpy as np
import torch

from mcquic_tpu_torch.validate.metrics import msSSIM, psnr


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images)).to(device).permute(0, 3, 1, 2).float()


class Handler:
    """Accumulates per-batch results; `.result()` is the running mean."""

    def __init__(self):
        self._values: List[float] = []

    def reset(self):
        self._values = []

    def result(self) -> float:
        return float(np.mean(self._values)) if self._values else float("nan")

    def __call__(self, **kwargs):
        raise NotImplementedError


class MsSSIMHandler(Handler):
    """MS-SSIM on the uint8 range (reference handlers.py MsSSIM)."""

    def __init__(self, device):
        super().__init__()
        self._device = device

    def __call__(self, *, images, restored, **_):
        with torch.inference_mode():
            value = msSSIM(_nchw(images, self._device), _nchw(restored, self._device),
                           dataRange=255.0)
        self._values.append(float(value))


class PSNRHandler(Handler):
    """PSNR in dB on the uint8 range (reference handlers.py PSNR)."""

    def __init__(self, device):
        super().__init__()
        self._device = device

    def __call__(self, *, images, restored, **_):
        with torch.inference_mode():
            value = psnr(_nchw(images, self._device), _nchw(restored, self._device),
                         dataRange=255.0)
        self._values.append(float(value))


class BPPHandler(Handler):
    """Bits per pixel of the actual rANS streams (reference handlers.py:45-58)."""

    def __call__(self, *, binaries, pixels, **_):
        self._values.append(sum(len(b) for b in binaries) * 8 / pixels)


class IdealBPPHandler(Handler):
    """The codes' information under the coder's frequency tables, in bits
    per pixel: the bound rANS approaches (reference handlers.py:110-190)."""

    def __call__(self, *, codes, normalizedFreqs, pixels, batch=1, **_):
        totalBits = 0.0
        for code, freq in zip(codes, normalizedFreqs):
            for g in range(code.shape[1]):
                p = np.maximum(freq[g], 1e-12)
                totalBits += float(np.sum(-np.log2(p[code[:, g].ravel()])))
        self._values.append(totalBits / (pixels * batch))


class ImageCollector(Handler):
    """Keeps up to `maxItems` (original, restored) pairs for inspection
    (reference handlers.py ImageCollector / Visualization)."""

    def __init__(self, maxItems: int = 16):
        super().__init__()
        self._maxItems = maxItems
        self._images: List = []

    def reset(self):
        super().reset()
        self._images = []

    def __call__(self, *, images, restored, **_):
        if len(self._images) < self._maxItems:
            self._images.append((np.asarray(images[0]), np.asarray(restored[0])))

    def result(self):
        return self._images


class Meters:
    """A named collection of handlers, all fed the same keyword arguments."""

    def __init__(self, handlers: Dict[str, Handler]):
        self._handlers = handlers

    def reset(self):
        for h in self._handlers.values():
            h.reset()

    def __call__(self, **kwargs):
        for h in self._handlers.values():
            h(**kwargs)

    def results(self) -> Dict[str, float]:
        return {name: h.result() for name, h in self._handlers.items()}
