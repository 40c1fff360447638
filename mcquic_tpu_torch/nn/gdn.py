"""Generalized divisive normalization, NCHW (reference mcquic/nn/gdn.py).

    y[i] = x[i] * rsqrt(beta[i] + sum_j gamma[i, j] x[j]^2)   (GDN)
    y[i] = x[i] *  sqrt(beta[i] + sum_j gamma[i, j] x[j]^2)   (IGDN)

beta [C] and gamma [C_out, C_in] are stored in reparam space, as in the
reference and the JAX package (whose gamma is laid out [1, C_in, C_out]).
"""
import torch
import torch.nn.functional as F
from torch import nn

from mcquic_tpu_torch.nn.functional import nonNegativeApply


BETA_BOUND = 1e-4


class GenDivNorm(nn.Module):
    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.ones(channels))
        self.gamma = nn.Parameter(torch.eye(channels) * 0.1)

    def forward(self, x):
        beta = nonNegativeApply(self.beta, minimum=BETA_BOUND)
        gamma = nonNegativeApply(self.gamma)
        c = gamma.shape[0]
        std = F.conv2d(x * x, gamma.view(c, c, 1, 1), beta)
        return x * (torch.sqrt(std) if self.inverse else torch.rsqrt(std))


class InvGenDivNorm(GenDivNorm):
    def __init__(self, channels: int):
        super().__init__(channels, inverse=True)
