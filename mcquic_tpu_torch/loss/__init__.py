"""The metric half of the losses, NCHW (counterpart of
`mcquic_tpu/loss/__init__.py`, reference `mcquic/loss/__init__.py:27-62`):
the distortions MS-SSIM and PSNR with their dB formatting, and the
codebook-repulsion rate term. The distortions are registered in
`utils/registry.py::LossRegistry`, where a config's `target` finds them.
The perceptual term is `loss/lpips.py`.
"""
from typing import Callable, Sequence

import torch

from mcquic_tpu_torch.utils.registry import LossRegistry
from mcquic_tpu_torch.validate.metrics import msSSIM


def decibel(upperBound: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """A distortion in dB against `upperBound` (reference validate/utils.py:6-12)."""
    ub2 = upperBound ** 2

    def fmt(x):
        return -10 * torch.log10(torch.clamp(x / ub2, min=1e-12))

    return fmt


class Distortion:
    formatDistortion = staticmethod(lambda x: x)

    def __call__(self, restored, image, codes=None, logits=None):
        raise NotImplementedError


@LossRegistry.register
class MsSSIM(Distortion):
    """1 - MS-SSIM of images in [-1, 1] (data range 2), shown in dB against 1."""
    formatDistortion = staticmethod(decibel(1.0))

    def __call__(self, restored, image, codes=None, logits=None):
        return 1.0 - msSSIM(restored + 1, image + 1, dataRange=2.0)


@LossRegistry.register
class PSNR(Distortion):
    """Mean squared error of images in [-1, 1], shown in dB against 2."""
    formatDistortion = staticmethod(decibel(2.0))

    def __call__(self, restored, image, codes=None, logits=None):
        return ((restored - image) ** 2).mean()


class BasicRate:
    """gamma * the sum of positive off-diagonal codeword cosines, per group
    of every codebook [m, k, d] (loss/__init__.py:27-44)."""

    def __init__(self, gamma: float = 0.0):
        self._gamma = gamma

    def __call__(self, logits, codebooks: Sequence[torch.Tensor]) -> torch.Tensor:
        if self._gamma == 0.0:
            return torch.tensor(0.0)
        total = 0.0
        for codebook in codebooks:
            for c in codebook:                    # [k, d] per group
                norm = (c * c).sum(-1)
                cos = (c @ c.T) / torch.sqrt(norm[:, None] * norm)
                total = total + torch.triu(torch.clamp(cos, 0.0, 2.0), 1).sum()
        return self._gamma * total
