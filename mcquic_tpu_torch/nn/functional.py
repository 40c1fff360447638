"""Functional primitives, NCHW.

Counterpart of `mcquic_tpu/nn/functional.py` for inference:
  * `pixelShuffle` / `pixelUnshuffle` — channel index read as (c, i, j),
    the order of `torch.nn.PixelShuffle` and of the JAX package's NHWC form.
  * `nonNegativeApply` — the non-negative reparametrization GDN uses: the
    stored value is bounded below, squared, and shifted by eps^2.
"""
import torch
import torch.nn.functional as F

EPS = 1e-6


def pixelShuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[n, c*r*r, h, w] -> [n, c, h*r, w*r]"""
    return F.pixel_shuffle(x, r)


def pixelUnshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[n, c, h*r, w*r] -> [n, c*r*r, h, w]"""
    return F.pixel_unshuffle(x, r)


def nonNegativeApply(x: torch.Tensor, minimum: float = 0.0, eps: float = EPS) -> torch.Tensor:
    """Recover the (>= minimum) value from reparam space (forward only)."""
    eps2 = eps * eps
    bound = (minimum + eps2) ** 0.5
    out = torch.clamp_min(x, bound)
    return out * out - eps2
