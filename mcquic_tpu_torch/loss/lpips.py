"""LPIPS, the perceptual term of the stage-1 loss, NCHW (counterpart of
`mcquic_tpu/loss/lpips.py`, reference `mcquic/loss/lpips.py`): the five
ReLU taps of a VGG16 feature stack, unit-normalized along channels, their
squared difference through learned 1x1 heads, averaged over space and
summed over taps, at 224x224.

The five lin heads are the reference's (`lpips_vgg.pth`), shipped as this
package's own `lpips_lin.npz` (the same arrays as the JAX package's, flax
HWIO). The VGG16 backbone is torchvision's pretrained `vgg16`, which the
repo does not carry: give its state dict in `MCQUIC_VGG16_WEIGHTS` (or at
`~/.cache/mcquic_tpu/vgg16.pth`). Without it `makeDefaultLpipsFn` returns
None after one loud warning, and the trainer trains without the term, as
the JAX trainer does (`lpips.py:162-192`). `MCQUIC_LPIPS_PROXY=1` puts a
seeded random-feature proxy in the slot instead, always labeled "proxy":
a random VGG16 drawn from a `torch.Generator` with flax's initializers'
distributions and uniform lin heads. Its values are not the JAX proxy's,
whose draws come from `jax.random`.

The resize to 224x224 is `F.interpolate(bilinear, antialias=True)`, which
is `jax.image.resize(..., "bilinear")`: a triangle filter widened by the
scale when it shrinks (256 -> 224), plain bilinear when it grows.
"""
import logging
import math
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger("mcquic_tpu_torch.lpips")

# VGG16: (channels, convs) per stage; a tap after each stage's last ReLU
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
SIZE = 224
BUNDLED_LIN = Path(__file__).resolve().parent / "lpips_lin.npz"
PROXY_SEED = 3407
_warnedOnce = False


class VGG16Features(nn.Module):
    """13 3x3 convs `conv0..conv12` with ReLUs, max-pooled between stages;
    returns the five stage outputs."""

    def __init__(self):
        super().__init__()
        convs, inChannels = [], 3
        for channels, count in VGG_STAGES:
            for _ in range(count):
                convs.append(nn.Conv2d(inChannels, channels, 3, padding=1))
                inChannels = channels
        for i, conv in enumerate(convs):
            self.add_module(f"conv{i}", conv)

    def forward(self, x):
        taps, i = [], 0
        for stage, (_, count) in enumerate(VGG_STAGES):
            for _ in range(count):
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
            taps.append(x)
            if stage < len(VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps


class LPIPS(nn.Module):
    """Perceptual distance of two NCHW batches in [-1, 1], as a scalar (the
    batch mean)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (channels, _) in enumerate(VGG_STAGES):
            self.add_module(f"lin{i}", nn.Conv2d(channels, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x, y):
        fx = self.vgg((x - self.shift.to(x.dtype)) / self.scale.to(x.dtype))
        fy = self.vgg((y - self.shift.to(y.dtype)) / self.scale.to(y.dtype))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean((1, 2, 3))
        return total.mean()


def resize224(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [n, c, 224, 224], `jax.image.resize(..., "bilinear")`."""
    return F.interpolate(x, size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                         antialias=True)


def makeLpipsFn(module: LPIPS) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """lpips(xHat, x) -> scalar at 224x224 through `module`, whose weights
    are frozen (gradients reach xHat only)."""
    for p in module.parameters():
        p.requires_grad_(False)
    module.eval()

    def fn(xHat, x):
        return module(resize224(xHat), resize224(x))

    return fn


def loadBundledLinHeads() -> dict:
    """The reference's lin heads as `linN.weight` [1, C, 1, 1]."""
    with np.load(BUNDLED_LIN) as data:
        return {f"{name}.weight": torch.from_numpy(np.transpose(data[name], (3, 2, 0, 1)).copy())
                for name in data.files}


def findVggWeights() -> Optional[str]:
    """A torchvision VGG16 state dict: `MCQUIC_VGG16_WEIGHTS`, then
    `~/.cache/mcquic_tpu/vgg16.pth`."""
    for path in (os.environ.get("MCQUIC_VGG16_WEIGHTS", ""),
                 os.path.expanduser("~/.cache/mcquic_tpu/vgg16.pth")):
        if path and os.path.exists(path):
            return path
    return None


def convertVggStateDict(vsd) -> dict:
    """torchvision `vgg16().state_dict()` (or its `features.` part) ->
    `vgg.convN.weight/bias`, the conv layers in index order."""
    convKeys = sorted((k for k in vsd if k.startswith("features.") and k.endswith(".weight")
                       and len(tuple(vsd[k].shape)) == 4), key=lambda k: int(k.split(".")[1]))
    out = {}
    for i, key in enumerate(convKeys):
        out[f"vgg.conv{i}.weight"] = torch.as_tensor(np.asarray(vsd[key])).float()
        out[f"vgg.conv{i}.bias"] = torch.as_tensor(
            np.asarray(vsd[key.replace(".weight", ".bias")])).float()
    return out


def proxyModule(seed: int = PROXY_SEED) -> LPIPS:
    """The LPIPS architecture with a seeded random VGG16 (flax's conv
    initializers: kernels lecun-normal, truncated at two deviations, biases
    zero) and lin heads that average the channels."""
    module = LPIPS()
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.startswith("lin"):
                p.fill_(1.0 / p.shape[1])
            elif name.endswith("bias"):
                p.zero_()
            else:
                std = math.sqrt(1.0 / int(np.prod(p.shape[1:]))) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
    return module


def makeDefaultLpipsFn(device):
    """The LPIPS term from the bundled lin heads and a VGG16 backbone found
    by `findVggWeights`, on `device`; with no backbone, the proxy under
    MCQUIC_LPIPS_PROXY=1, else None after one loud warning."""
    global _warnedOnce
    vggPath = findVggWeights()
    if vggPath is None:
        if os.environ.get("MCQUIC_LPIPS_PROXY", ""):
            banner = ("LPIPS PROXY ACTIVE: seeded random-feature perceptual distance in the lpips "
                      "slot (MCQUIC_LPIPS_PROXY=1). This is NOT the reference's trained VGG16-LPIPS.")
            logger.warning(banner)
            print(banner, flush=True)
            return makeLpipsFn(proxyModule().to(device))
        if not _warnedOnce:
            _warnedOnce = True
            banner = ("\n" + "!" * 78 + "\n"
                      "! LPIPS DISABLED: no VGG16 backbone weights found.\n"
                      "! The published objective is 0.5*recon + 0.5*mse + 2*lpips; the\n"
                      "! 2x-weighted perceptual term will train as ZERO.\n"
                      "! Provide torchvision vgg16 weights via MCQUIC_VGG16_WEIGHTS or\n"
                      "! ~/.cache/mcquic_tpu/vgg16.pth to restore the reference loss.\n"
                      + "!" * 78)
            logger.warning(banner)
            print(banner, flush=True)
        return None
    module = LPIPS()
    state = {**loadBundledLinHeads(),
             **convertVggStateDict(torch.load(vggPath, map_location="cpu"))}
    module.load_state_dict(state, strict=True)
    logger.info("LPIPS enabled: lin heads (bundled) + VGG16 backbone from %s", vggPath)
    return makeLpipsFn(module.to(device))
