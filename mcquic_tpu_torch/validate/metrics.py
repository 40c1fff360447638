"""Image metrics, NCHW: SSIM, MS-SSIM and PSNR (counterpart of
`mcquic_tpu/validate/metrics.py`, reference `mcquic/validate/metrics.py:22-274`).

SSIM filters with a separable Gaussian window (a depthwise conv along H,
then along W, no padding). Like the JAX package, every metric computes in
float32 whatever its inputs are.
"""
from typing import Sequence

import torch
import torch.nn.functional as F

MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian1d(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _gaussianFilter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise blur of [n, c, h, w] by the window along H, then along W."""
    c, size = x.shape[1], win.numel()
    x = F.conv2d(x, win.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c)


def _ssimPerChannel(x, y, win, dataRange: float, k1: float = 0.01, k2: float = 0.03):
    c1 = (k1 * dataRange) ** 2
    c2 = (k2 * dataRange) ** 2
    mu1, mu2 = _gaussianFilter(x, win), _gaussianFilter(y, win)
    mu1Sq, mu2Sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1Sq = _gaussianFilter(x * x, win) - mu1Sq
    sigma2Sq = _gaussianFilter(y * y, win) - mu2Sq
    sigma12 = _gaussianFilter(x * y, win) - mu12
    csMap = (2 * sigma12 + c2) / (sigma1Sq + sigma2Sq + c2)
    ssimMap = ((2 * mu12 + c1) / (mu1Sq + mu2Sq + c1)) * csMap
    return ssimMap.mean((2, 3)), csMap.mean((2, 3))             # [n, c] each


def ssim(x: torch.Tensor, y: torch.Tensor, dataRange: float = 255.0, winSize: int = 11,
         winSigma: float = 1.5, sizeAverage: bool = True) -> torch.Tensor:
    """SSIM of [n, c, h, w] batches (reference metrics.py:90-130)."""
    win = _gaussian1d(winSize, winSigma, x.device)
    val, _ = _ssimPerChannel(x.float(), y.float(), win, dataRange)
    val = val.mean(-1)
    return val.mean() if sizeAverage else val


def msSSIM(x: torch.Tensor, y: torch.Tensor, dataRange: float = 255.0, winSize: int = 11,
           winSigma: float = 1.5, weights: Sequence[float] = MS_WEIGHTS,
           sizeAverage: bool = True) -> torch.Tensor:
    """Multi-scale SSIM of [n, c, h, w] batches (reference metrics.py:133-193).

    As in the JAX package, scales stop where the Gaussian window no longer
    fits (the weights are renormalized), and the contrast and SSIM terms are
    floored at 1e-4 before the weighted product."""
    x, y = x.float(), y.float()
    win = _gaussian1d(winSize, winSigma, x.device)
    levels, side = 1, min(x.shape[2], x.shape[3])
    while side // 2 >= winSize and levels < len(weights):
        levels += 1
        side //= 2
    weights = list(weights[:levels])
    weights = torch.tensor([w / sum(weights) for w in weights], dtype=torch.float32,
                           device=x.device)
    floor = 1e-4
    mcs = []
    for i in range(levels):
        ssimVal, cs = _ssimPerChannel(x, y, win, dataRange)
        if i < levels - 1:
            mcs.append(torch.clamp(cs, min=floor))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    stack = torch.stack(mcs + [torch.clamp(ssimVal, min=floor)])    # [levels, n, c]
    out = torch.prod(stack ** weights[:, None, None], 0).mean(-1)
    return out.mean() if sizeAverage else out


def psnr(x: torch.Tensor, y: torch.Tensor, dataRange: float = 255.0,
         sizeAverage: bool = True) -> torch.Tensor:
    """PSNR in dB of [n, c, h, w] batches (reference metrics.py:258-274)."""
    mse = ((x.float() - y.float()) ** 2).mean((1, 2, 3))
    val = 10 * torch.log10(dataRange ** 2 / torch.clamp(mse, min=1e-12))
    return val.mean() if sizeAverage else val
