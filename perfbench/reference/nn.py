"""Plain PyTorch blocks of McQuic's codecs, NCHW, fp32.

A frozen, independent statement of the blocks the benchmark holds the
program to: every convolution is `torch.nn.Conv2d`, every up-convolution a
convolution followed by `pixel_shuffle`, GDN a 1x1 convolution of the
squares. Parameter names follow the reference McQuic state dict
(`_branch.N`, `_skip`, `_mainBranch.N`, `_sideBranch.N`), so one state dict
loads into both sides.

    ResidualBlock            SiLU-conv3x3-SiLU-conv3x3 + skip (x, or conv1x1
                             where the width changes)
    ResidualBlockWithStride  SiLU-conv3x3/s-GDN-conv3x3 + conv3x3/s skip
    ResidualBlockShuffle     SiLU-upconv3x3-IGDN-conv3x3 + upconv3x3 skip
    AttentionBlock           main(3 ResB) * sigmoid(side(3 ResB, conv1x1)) + x
"""
import torch
import torch.nn.functional as F
from torch import nn

GDN_EPS = 1e-6                  # the reparametrization's epsilon
GDN_BETA_MIN = 1e-4


def conv(cin: int, cout: int, kernel: int, stride: int = 1, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=bias)


class UpConv(nn.Sequential):
    """conv3x3 to cout * r * r channels, then a pixel shuffle by r
    (channel index read as (c, i, j))."""

    def __init__(self, cin: int, cout: int, r: int = 2):
        super().__init__(conv(cin, cout * r * r, 3), nn.PixelShuffle(r))


def _reparam(x: torch.Tensor, minimum: float) -> torch.Tensor:
    eps2 = GDN_EPS * GDN_EPS
    return torch.clamp_min(x, (minimum + eps2) ** 0.5) ** 2 - eps2


class GDN(nn.Module):
    """y = x / sqrt(beta + gamma x^2) (inverse: times), beta and gamma
    stored in reparam space."""

    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.ones(channels))
        self.gamma = nn.Parameter(torch.eye(channels))

    def forward(self, x):
        c = x.shape[1]
        norm = F.conv2d(x * x, _reparam(self.gamma, 0.0).view(c, c, 1, 1),
                        _reparam(self.beta, GDN_BETA_MIN))
        return x * torch.sqrt(norm) if self.inverse else x / torch.sqrt(norm)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int = None):
        super().__init__()
        cout = cout or cin
        self._branch = nn.Sequential(nn.SiLU(), conv(cin, cout, 3), nn.SiLU(), conv(cout, cout, 3))
        self._skip = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        return self._branch(x) + (x if self._skip is None else self._skip(x))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, c: int, stride: int = 2):
        super().__init__()
        self._branch = nn.Sequential(nn.SiLU(), conv(c, c, 3, stride), GDN(c), conv(c, c, 3))
        self._skip = conv(c, c, 3, stride)

    def forward(self, x):
        return self._branch(x) + self._skip(x)


class ResidualBlockShuffle(nn.Module):
    def __init__(self, c: int, r: int = 2):
        super().__init__()
        self._branch = nn.Sequential(nn.SiLU(), UpConv(c, c, r), GDN(c, inverse=True),
                                     conv(c, c, 3))
        self._skip = UpConv(c, c, r)

    def forward(self, x):
        return self._branch(x) + self._skip(x)


class AttentionBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self._mainBranch = nn.Sequential(*[ResidualBlock(c) for _ in range(3)])
        self._sideBranch = nn.Sequential(*[ResidualBlock(c) for _ in range(3)], conv(c, c, 1))

    def forward(self, x):
        return self._mainBranch(x) * torch.sigmoid(self._sideBranch(x)) + x


def nearest(tokens: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared distances of tokens [m, T, d] to codebook [m, k, d] -> [m, T, k],
    as |x|^2 - 2 x.c + |c|^2 in the tensors' precision."""
    x2 = (tokens * tokens).sum(-1, keepdim=True)
    c2 = (codebook * codebook).sum(-1)[:, None, :]
    return x2 - 2.0 * torch.bmm(tokens, codebook.transpose(1, 2)) + c2


def toTokens(x: torch.Tensor, m: int) -> torch.Tensor:
    """Latent [n, m*d, h, w] -> tokens [m, n*h*w, d] (group g owns channels
    g*d .. (g+1)*d - 1)."""
    n, c, h, w = x.shape
    return x.reshape(n, m, c // m, h, w).permute(1, 0, 3, 4, 2).reshape(m, n * h * w, c // m)


def dequantize(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """codes [n, m, h, w], codebook [m, k, d] -> latent [n, m*d, h, w]."""
    m, k, d = codebook.shape
    n, _, h, w = codes.shape
    picked = torch.stack([codebook[g][codes[:, g].long()] for g in range(m)], 1)  # n m h w d
    return picked.permute(0, 1, 4, 2, 3).reshape(n, m * d, h, w)
