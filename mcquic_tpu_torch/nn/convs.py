"""Convolutions, NCHW, named like the reference McQuic state dict.

Counterpart of `mcquic_tpu/nn/convs.py`: `conv3x3`/`conv5x5`/`conv1x1` are
`torch.nn.Conv2d` with explicit symmetric padding k//2, which is what the
JAX package's `Conv` pads at every stride. `PixelShuffleConv` is
`Sequential(conv, PixelShuffle)` at rate > 1, `Sequential(conv,
PixelUnshuffle)` at rate < 1 (torch's channel order (c, i, j) is the JAX
package's, `nn/functional.py:113`) and `Sequential(conv, Identity)` at rate
1, so its weights sit at `<name>.0.*` at every rate. `MaskedConv` is the
PixelCNN-style masked convolution (`convs.py:220-256`).

A thin up-conv (3x3, ungrouped, fewer than 32 output channels after the
shuffle; in the v1 codec only the decoder's final RGB head) runs through
`ops/subpixel_cuda.py::conv3x3SubpixelThin` where the JAX package's
`_UpConv` takes its Pallas head: the kernel takes the shapes
(`thinHeadSupported`), the input is fp32, and no gradient is needed. That
is kernel K2 on CUDA and its plain version on the CPU. Every other up-conv
is `conv2d` + `pixel_shuffle`.

The JAX package's `subpixelConvTranspose` (`MCQUIC_SUBPIXEL=deconv`) is the
same function with the same parameters, written as one transposed
convolution for the TPU; the port has the one formulation.
"""
import torch
import torch.nn.functional as F
from torch import nn

from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelThin, thinHeadSupported

THIN_FEATURES = 32


def conv(inChannels: int, outChannels: int, kernel: int, stride: int = 1,
         bias: bool = True, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(inChannels, outChannels, kernel, stride=stride,
                     padding=kernel // 2, bias=bias, groups=groups)


def conv3x3(inChannels: int, outChannels: int, stride: int = 1, bias: bool = True,
            groups: int = 1) -> nn.Conv2d:
    return conv(inChannels, outChannels, 3, stride, bias, groups)


def conv5x5(inChannels: int, outChannels: int, stride: int = 1, bias: bool = True,
            groups: int = 1) -> nn.Conv2d:
    return conv(inChannels, outChannels, 5, stride, bias, groups)


def conv1x1(inChannels: int, outChannels: int, stride: int = 1, bias: bool = True,
            groups: int = 1) -> nn.Conv2d:
    return conv(inChannels, outChannels, 1, stride, bias, groups)


class PixelShuffleConv(nn.Sequential):
    """conv(k) + pixel shuffle (reference convs.py:151-255): at rate > 1 a
    conv to features * r^2 then a shuffle up by r; at rate 1 a conv to
    features; at rate < 1 a conv to features / r^2 (r = 1 / rate) then a
    shuffle down by r."""

    def __init__(self, inChannels: int, features: int, kernel: int = 3, rate: float = 2,
                 groups: int = 1, bias: bool = True):
        if rate < 1:
            r = int(round(1 / rate))
            layers = (conv(inChannels, features // (r * r), kernel, bias=bias, groups=groups),
                      nn.PixelUnshuffle(r))
        elif rate == 1:
            r = 1
            layers = (conv(inChannels, features, kernel, bias=bias, groups=groups), nn.Identity())
        else:
            r = int(rate)
            layers = (conv(inChannels, features * r * r, kernel, bias=bias, groups=groups),
                      nn.PixelShuffle(r))
        super().__init__(*layers)
        self.rate = r
        self.thin = rate > 1 and kernel == 3 and groups == 1 and features < THIN_FEATURES

    def forward(self, x):
        conv = self[0]
        if (self.thin and x.dtype == torch.float32
                and thinHeadSupported(x.shape, conv.weight.shape, self.rate)
                and not (torch.is_grad_enabled() and any(
                    t is not None and t.requires_grad for t in (x, conv.weight, conv.bias)))):
            return conv3x3SubpixelThin(x, conv.weight, conv.bias, self.rate)
        return super().forward(x)


def pixelShuffle3x3(inChannels: int, features: int, rate: float = 2,
                    groups: int = 1) -> PixelShuffleConv:
    return PixelShuffleConv(inChannels, features, 3, rate, groups)


def pixelShuffle5x5(inChannels: int, features: int, rate: float = 2,
                    groups: int = 1) -> PixelShuffleConv:
    return PixelShuffleConv(inChannels, features, 5, rate, groups)


def pixelShuffle1x1(inChannels: int, features: int, rate: float = 2,
                    groups: int = 1) -> PixelShuffleConv:
    return PixelShuffleConv(inChannels, features, 1, rate, groups)


class MaskedConv(nn.Conv2d):
    """PixelCNN-style masked conv (reference convs.py:33-75): taps after the
    centre row are zero, and in the centre row those after the centre
    column (type B) or at and after it (type A). The mask is multiplied
    into the weight on every forward, so masked taps never leak through an
    optimizer's update. No bias by default, as in the JAX package."""

    def __init__(self, inChannels: int, features: int, kernel: int = 5, maskType: str = "A",
                 bias: bool = False):
        if maskType not in ("A", "B"):
            raise ValueError(f"Invalid maskType {maskType!r}")
        super().__init__(inChannels, features, kernel, padding=kernel // 2, bias=bias)
        mask = torch.ones(1, 1, kernel, kernel)
        centre = kernel // 2
        mask[..., centre, centre + (1 if maskType == "B" else 0):] = 0
        mask[..., centre + 1:, :] = 0
        self.register_buffer("mask", mask, persistent=False)
        self.maskType = maskType

    def forward(self, x):
        return F.conv2d(x, self.weight * self.mask.to(self.weight.dtype), self.bias,
                        padding=self.padding)
