"""The Inception Score (counterpart of `mcquic_tpu/validate/inception.py`,
reference `validate/handlers.py:193-258`): IS = exp(E_x KL(p(y|x) || p(y)))
over generated images, from an InceptionV3 classifier.

The JAX handler resizes each image to 299 x 299 with PIL's `BILINEAR`. The
port does not import PIL, so `resizeBilinear` computes PIL's resample on
the device: a triangle filter whose support widens by the scale factor when
it shrinks an image, weights normalized per output pixel and stored as
22-bit fixed point, a horizontal pass then a vertical one, each rounded to
uint8 (Pillow's `Resample.c`, 8 bits per channel). On upscaling this is not
`F.interpolate(align_corners=False)`.
"""
import math
from typing import Callable, List, Optional

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2          # Pillow's fixed point for 8-bit images


def _bilinearCoefficients(inSize: int, outSize: int) -> np.ndarray:
    """[outSize, inSize] int64: PIL's fixed-point bilinear weights, each
    output pixel's row summing to about 1 << PRECISION_BITS. The float
    operations are Pillow's `precompute_coeffs`, in its order (doubles)."""
    scale = inSize / outSize
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    out = np.zeros((outSize, inSize), np.int64)
    for xx in range(outSize):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), inSize) - xmin
        weights = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            weights.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for w in weights:
            total += w
        for x, w in enumerate(weights):
            w = w / total if total != 0.0 else w
            # C's (int) truncation of +-0.5 + w * 2^22
            out[xx, xmin + x] = math.trunc((-0.5 if w < 0 else 0.5) + w * (1 << PRECISION_BITS))
    return out


def _pass(images: torch.Tensor, coefficients: np.ndarray, axis: int) -> torch.Tensor:
    """One resample pass along `axis` of uint8 [n, h, w, c]: the weighted
    sum in exact integers (products of 8-bit values and 22-bit weights, in
    fp64), plus half, shifted down and clipped to uint8."""
    weights = torch.from_numpy(coefficients.astype(np.float64)).to(images.device)
    x = images.double()
    y = torch.einsum("oi,nicx->nocx" if axis == 1 else "oi,nhic->nhoc", weights, x)
    y = (y + float(1 << (PRECISION_BITS - 1))).long() >> PRECISION_BITS
    return y.clamp(0, 255).to(torch.uint8)


def resizeBilinear(images, size: int = 299) -> torch.Tensor:
    """uint8 NHWC images (numpy or tensor) -> uint8 [n, size, size, c] by
    PIL's `Image.resize((size, size), BILINEAR)`, on the images' device."""
    x = torch.as_tensor(images)
    _, h, w, _ = x.shape
    if w != size:
        x = _pass(x, _bilinearCoefficients(w, size), 2)
    if h != size:
        x = _pass(x, _bilinearCoefficients(h, size), 1)
    return x


class InceptionScoreHandler:
    """Accumulates the class probabilities of the `restored` images and
    reports their Inception Score over `splits` splits. `classifierFn` maps
    uint8 [n, 299, 299, 3] to logits [n, 1000] (by default the network
    `makeInceptionClassifier(device)` finds); without one the call is
    refused."""

    def __init__(self, device, classifierFn: Optional[Callable] = None, splits: int = 10):
        if classifierFn is None:
            from mcquic_tpu_torch.validate.inception_v3 import makeInceptionClassifier
            classifierFn = makeInceptionClassifier(device)
        self._device = torch.device(device)
        self._classifierFn = classifierFn
        self._splits = splits
        self._probs: List[np.ndarray] = []

    def reset(self):
        self._probs = []

    def __call__(self, *, restored, **_):
        if self._classifierFn is None:
            raise RuntimeError(
                "InceptionScore needs a classifier: pass classifierFn "
                "(InceptionV3 weights are not bundled — point MCQUIC_INCEPTION_WEIGHTS at "
                "torchvision's inception_v3 state dict).")
        images = resizeBilinear(torch.as_tensor(np.asarray(restored)).to(self._device))
        logits = self._classifierFn(images)
        logits = logits.detach().cpu().numpy() if torch.is_tensor(logits) else np.asarray(logits)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        self._probs.append(e / e.sum(-1, keepdims=True))

    def result(self) -> float:
        """The score's mean over the splits (reference handlers.py:240-256)."""
        if not self._probs:
            return float("nan")
        probs = np.concatenate(self._probs, 0)
        scores = []
        for part in np.array_split(probs, min(self._splits, probs.shape[0])):
            marginal = part.mean(0, keepdims=True)
            kl = (part * (np.log(part + 1e-12) - np.log(marginal + 1e-12))).sum(-1)
            scores.append(float(np.exp(kl.mean())))
        return float(np.mean(scores))
