"""InceptionV3 for the Inception Score (counterpart of
`mcquic_tpu/validate/inception_v3.py`; reference `validate/handlers.py:193-258`,
torchvision's `inception_v3(transform_input=False)`).

The modules carry torchvision's names (`Conv2d_1a_3x3`, `Mixed_5b.branch1x1`,
..., `fc`). BatchNorm runs in inference only, so its running statistics are
folded into a per-channel scale and shift when a torchvision state dict is
loaded (`foldTorchvisionStateDict`, as `convertTorchInception` folds them,
BN_EPS 1e-3): a `BasicConv2d` holds `conv.weight`, `scale` and `shift`. The
auxiliary classifier (`AuxLogits.*`) is dropped. No weights are in the
repository: `findInceptionWeights` reads MCQUIC_INCEPTION_WEIGHTS, then
`~/.cache/mcquic_tpu/inception_v3.pth`, and without either the Inception
Score stays refused (`validate/inception.py`). The convolutions run through
cuDNN in fp32 with TF32 off (`utils.exactFp32`), as every network of the port.
"""
import logging
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mcquic_tpu_torch.utils import exactFp32

logger = logging.getLogger("mcquic_tpu_torch.inception")

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias), the folded BatchNorm, relu."""

    def __init__(self, cIn: int, cOut: int, kernel=3, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cIn, cOut, kernel, stride, padding, bias=False)
        self.register_buffer("scale", torch.ones(cOut))
        self.register_buffer("shift", torch.zeros(cOut))

    def forward(self, x):
        y = self.conv(x)
        return torch.relu(y * self.scale[:, None, None] + self.shift[:, None, None])


def _avgPool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _maxPool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cIn: int, poolFeatures: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cIn, 64, 1)
        self.branch5x5_1 = BasicConv2d(cIn, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cIn, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cIn, poolFeatures, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avgPool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cIn: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cIn, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cIn, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxPool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cIn: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cIn, 192, 1)
        self.branch7x7_1 = BasicConv2d(cIn, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cIn, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cIn, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgPool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cIn: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cIn, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cIn, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _maxPool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cIn: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cIn, 320, 1)
        self.branch3x3_1 = BasicConv2d(cIn, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cIn, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cIn, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgPool3(x))], 1)


class InceptionV3(nn.Module):
    """torchvision's inception_v3 (transform_input=False) without the
    auxiliary classifier: float NCHW in [-1, 1] at 299 x 299 -> [n, 1000]
    logits."""

    def __init__(self, numClasses: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, numClasses)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxPool3s2(x)))
        x = _maxPool3s2(x)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return self.fc(x.mean((2, 3)))


def foldTorchvisionStateDict(stateDict) -> Dict[str, torch.Tensor]:
    """A torchvision inception_v3 state dict -> `InceptionV3`'s, with each
    BatchNorm folded: scale = gamma / sqrt(var + BN_EPS), shift = beta -
    mean * scale, in fp32 from fp32 values, as `convertTorchInception`
    computes them in numpy. `AuxLogits.*` and the BatchNorms' batch counters
    are dropped."""
    sd = {k: np.asarray(torch.as_tensor(v).numpy()) for k, v in stateDict.items()
          if not k.startswith("AuxLogits")}
    out = {}
    for key in sorted(k for k in sd if k.endswith(".conv.weight")):
        prefix = key[:-len(".conv.weight")]
        scale = sd[f"{prefix}.bn.weight"] / np.sqrt(sd[f"{prefix}.bn.running_var"] + BN_EPS)
        shift = sd[f"{prefix}.bn.bias"] - sd[f"{prefix}.bn.running_mean"] * scale
        out[key] = torch.from_numpy(sd[key].astype(np.float32))
        out[f"{prefix}.scale"] = torch.from_numpy(scale.astype(np.float32))
        out[f"{prefix}.shift"] = torch.from_numpy(shift.astype(np.float32))
    out["fc.weight"] = torch.from_numpy(sd["fc.weight"].astype(np.float32))
    out["fc.bias"] = torch.from_numpy(sd["fc.bias"].astype(np.float32))
    return out


def seededStateDict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A torchvision inception_v3 state dict of numpy-seeded weights, for
    runs without the published ones: convolutions He-scaled, the BatchNorms'
    statistics near their init (so the activations keep their scale through
    the 94 convolutions), each BatchNorm's batch counter and one auxiliary
    classifier key, which the load drops. The network's cost does not depend
    on its weights; its score does."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in InceptionV3().state_dict().items():
        if not key.endswith(".conv.weight"):
            continue
        shape = tuple(value.shape)
        prefix, cOut = key[:-len(".conv.weight")], shape[0]
        sd[key] = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])), shape).astype(np.float32)
        sd[f"{prefix}.bn.weight"] = rng.uniform(0.5, 1.5, cOut).astype(np.float32)
        sd[f"{prefix}.bn.bias"] = rng.normal(0, 0.1, cOut).astype(np.float32)
        sd[f"{prefix}.bn.running_mean"] = rng.normal(0, 0.1, cOut).astype(np.float32)
        sd[f"{prefix}.bn.running_var"] = rng.uniform(0.5, 1.5, cOut).astype(np.float32)
        sd[f"{prefix}.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    sd["fc.weight"] = rng.normal(0, np.sqrt(1.0 / 2048), (1000, 2048)).astype(np.float32)
    sd["fc.bias"] = rng.normal(0, 0.01, 1000).astype(np.float32)
    sd["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1), np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def findInceptionWeights() -> Optional[str]:
    for path in (os.environ.get("MCQUIC_INCEPTION_WEIGHTS", ""),
                 os.path.expanduser("~/.cache/mcquic_tpu/inception_v3.pth")):
        if path and os.path.exists(path):
            return path
    return None


def inceptionFromStateDict(stateDict, device) -> InceptionV3:
    """The network on `device` from a torchvision state dict, in eval mode."""
    model = InceptionV3()
    model.load_state_dict(foldTorchvisionStateDict(stateDict), strict=True)
    return model.to(device).eval().requires_grad_(False)


def classifierOf(model: InceptionV3) -> Callable:
    """uint8 NHWC [n, 299, 299, 3] (numpy or tensor) -> fp32 logits
    [n, 1000] on the model's device; the images are mapped to [-1, 1] as the
    reference does (`handlers.py:231`)."""
    device = next(model.parameters()).device

    def classifierFn(images) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        x = x.to(device).permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
        with exactFp32(), torch.inference_mode():
            return model(x)

    return classifierFn


def makeInceptionClassifier(device) -> Optional[Callable]:
    """`classifierOf` the network whose weights `findInceptionWeights`
    locates, on `device`; None where there are none."""
    path = findInceptionWeights()
    if path is None:
        return None
    classifierFn = classifierOf(inceptionFromStateDict(torch.load(path, map_location="cpu"),
                                                       device))
    logger.info("InceptionScore classifier enabled from %s", path)
    return classifierFn
