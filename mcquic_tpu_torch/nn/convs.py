"""Convolutions, NCHW, named like the reference McQuic state dict.

Counterpart of `mcquic_tpu/nn/convs.py`: `conv3x3`/`conv1x1` are
`torch.nn.Conv2d` with explicit symmetric padding k//2, which is what the
JAX package's `Conv` pads at every stride. `PixelShuffleConv` is
`Sequential(conv, PixelShuffle)`, so its weights sit at `<name>.0.*`.

A thin up-conv (3x3, fewer than 32 output channels after the shuffle; in
the v1 codec only the decoder's final RGB head) runs through
`ops/subpixel_cuda.py::conv3x3SubpixelThin` where the JAX package's
`_UpConv` takes its Pallas head: the kernel takes the shapes
(`thinHeadSupported`), the input is fp32, and no gradient is needed. That
is kernel K2 on CUDA and its plain version on the CPU. Every other up-conv
is `conv2d` + `pixel_shuffle`.
"""
import torch
from torch import nn

from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelThin, thinHeadSupported

THIN_FEATURES = 32


def conv(inChannels: int, outChannels: int, kernel: int, stride: int = 1,
         bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(inChannels, outChannels, kernel, stride=stride,
                     padding=kernel // 2, bias=bias)


def conv3x3(inChannels: int, outChannels: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return conv(inChannels, outChannels, 3, stride, bias)


def conv1x1(inChannels: int, outChannels: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return conv(inChannels, outChannels, 1, stride, bias)


class PixelShuffleConv(nn.Sequential):
    """conv(k, features*r^2) + pixel shuffle by r (reference convs.py:151-255)."""

    def __init__(self, inChannels: int, features: int, kernel: int = 3, rate: int = 2):
        super().__init__(conv(inChannels, features * rate * rate, kernel),
                         nn.PixelShuffle(rate))
        self.rate = rate
        self.thin = kernel == 3 and features < THIN_FEATURES

    def forward(self, x):
        conv = self[0]
        if (self.thin and x.dtype == torch.float32
                and thinHeadSupported(x.shape, conv.weight.shape, self.rate)
                and not (torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad for t in (x, conv.weight, conv.bias)))):
            return conv3x3SubpixelThin(x, conv.weight, conv.bias, self.rate)
        return super().forward(x)


def pixelShuffle3x3(inChannels: int, features: int, rate: int = 2) -> PixelShuffleConv:
    return PixelShuffleConv(inChannels, features, 3, rate)
