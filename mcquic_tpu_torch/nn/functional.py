"""Functional primitives, NCHW, with the JAX package's custom gradients.

Counterpart of `mcquic_tpu/nn/functional.py` (reference `mcquic/nn/base.py`):
  * `pixelShuffle` / `pixelUnshuffle` — channel index read as (c, i, j),
    the order of `torch.nn.PixelShuffle` and of the JAX package's NHWC form.
  * `lowerBound` — max(x, bound) whose gradient passes where x >= bound or
    where it pushes x up (g < 0), as `functional.py:21-35`.
  * `nonNegativeApply` — the non-negative reparametrization GDN uses: the
    stored value is bounded below through `lowerBound`, squared, and
    shifted by eps^2.
  * `logExpMinusOne` — log(exp(x) - 1 + eps) with the straight gradient
    past log((1 + eps) / eps) (`functional.py:57-75`).
  * `gumbelSoftmax` — hard straight-through Gumbel-softmax
    (`functional.py:80-91`). It takes its uniforms as a tensor; the trainer
    draws them from a `torch.Generator`, the tests from jax.random.
"""
import math

import torch
import torch.nn.functional as F

EPS = 1e-6
FP32_EPS = 2.0 ** -23                 # jnp.finfo(jnp.float32).eps


def pixelShuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[n, c*r*r, h, w] -> [n, c, h*r, w*r]"""
    return F.pixel_shuffle(x, r)


def pixelUnshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[n, c, h*r, w*r] -> [n, c*r*r, h, w]"""
    return F.pixel_unshuffle(x, r)


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        passThrough = (x >= ctx.bound) | (g < 0)
        return passThrough.to(g.dtype) * g, None


def lowerBound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound); the gradient passes where x >= bound or g < 0."""
    return _LowerBound.apply(x, bound)


def nonNegativeApply(x: torch.Tensor, minimum: float = 0.0, eps: float = EPS) -> torch.Tensor:
    """Recover the (>= minimum) value from reparam space."""
    eps2 = eps * eps
    bound = (minimum + eps2) ** 0.5
    out = lowerBound(x, bound)
    return out * out - eps2


class _LogExpMinusOne(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.log(torch.exp(x) - 1 + FP32_EPS)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        ex = torch.exp(x)
        bound = math.log((1 + FP32_EPS) / FP32_EPS)
        return torch.where(x > bound, g, g * ex / (ex - 1 + FP32_EPS))


def logExpMinusOne(x: torch.Tensor) -> torch.Tensor:
    """log(exp(x) - 1 + eps), eps the fp32 machine epsilon at every dtype."""
    return _LogExpMinusOne.apply(x)


def gumbelSoftmax(logits: torch.Tensor, uniforms: torch.Tensor, temperature: float = 1.0,
                  hard: bool = True, dim: int = -1) -> torch.Tensor:
    """Gumbel-softmax of `logits` with the noise -log(-log(u)) of `uniforms`
    (same shape, in [0, 1), clipped to [eps, 1 - eps] of the logits' dtype).
    With `hard`, the forward value is the one-hot of the argmax and the
    gradient that of the soft sample (straight-through)."""
    eps = torch.finfo(logits.dtype).eps
    u = torch.clamp(uniforms.to(logits.dtype), eps, 1 - eps)
    gumbels = -torch.log(-torch.log(u))
    ySoft = torch.softmax((logits + gumbels) / temperature, dim)
    if not hard:
        return ySoft
    index = ySoft.argmax(dim, keepdim=True)
    yHard = torch.zeros_like(ySoft).scatter_(dim, index, 1.0)
    return yHard + ySoft - ySoft.detach()
