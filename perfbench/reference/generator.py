"""McQuic's stage-2 class-conditional next-scale generator
(`GeneratorV3SelfAttention`), plain PyTorch, fp32.

A transformer predicts the Neon tokenizer's codes level by level, small ->
large; every token attends to all tokens of the levels before its own and
to all of its own level (block-causal), and, through a tanh-gated
cross-attention, to the one condition token (McQuic
`modules/generator_3_self_attn.py`, with the AnyRes transformer of
`generator_3.py`). Each transformer block is adaLN-modulated with an
RMSNorm sandwich; q and k are LayerNorm-ed and get an additive position
embedding. The tokens of level l > 0 are the generator's own scaffold of
the codes of levels < l: each level's codes through a codebook of the
hidden width, summed into the upsampled scaffold below.

`logits` is the teacher-forced pass: one forward over the whole sequence
under the block-causal mask, which gives every level's logits from the
codes of the levels before it, as a KV-cached sampler computes them level
by level.
"""
import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.neon import Neon
from perfbench.reference.nn import UpConv, conv, dequantize

LN_EPS = 1e-6


def layerNorm(dim: int, affine: bool = True) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS, elementwise_affine=affine, bias=affine)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) * self.scale


class SwiGLU(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.w1 = nn.Linear(dim, 4 * dim, bias=False)
        self.w2 = nn.Linear(4 * dim, dim, bias=False)
        self.w3 = nn.Linear(dim, 4 * dim, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        for name in ("wq", "wk", "wv", "wo", "wkY", "wvY"):
            setattr(self, name, nn.Linear(dim, dim, bias=False))
        self.qNorm, self.kNorm, self.kyNorm = layerNorm(dim), layerNorm(dim), layerNorm(dim)
        self.gate = nn.Parameter(torch.zeros(heads))

    def forward(self, x, allowed, yFeat, pos):
        """x [b, T, dim]; allowed [T, T] bool; yFeat [b, 1, dim]; pos [T, dim]."""
        b, T, dim = x.shape
        H, hd = self.heads, dim // self.heads
        q = (self.qNorm(self.wq(x)) + pos).reshape(b, T, H, hd).transpose(1, 2)
        k = (self.kNorm(self.wk(x)) + pos).reshape(b, T, H, hd).transpose(1, 2)
        v = self.wv(x).reshape(b, T, H, hd).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
        scores = scores.masked_fill(~allowed, float("-inf"))
        out = torch.softmax(scores, -1) @ v                                  # b H T hd
        yk = self.kyNorm(self.wkY(yFeat)).reshape(b, -1, H, hd).transpose(1, 2)
        yv = self.wvY(yFeat).reshape(b, -1, H, hd).transpose(1, 2)
        yOut = torch.softmax(q @ yk.transpose(-1, -2) / math.sqrt(hd), -1) @ yv
        out = out + yOut * torch.tanh(self.gate)[None, :, None, None]
        return self.wo(out.transpose(1, 2).reshape(b, T, dim))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, eps: float):
        super().__init__()
        for name in ("attentionNorm", "attentionNorm1", "ffnNorm", "ffnNorm1", "attentionYNorm"):
            setattr(self, name, RMSNorm(dim, eps))
        self.adaLN = nn.Linear(dim, 6 * dim)
        self.attention = Attention(dim, heads)
        self.ffn = SwiGLU(dim)

    def forward(self, x, allowed, cond, yFeat, pos):
        shift1, scale1, gate1, shift2, scale2, gate2 = self.adaLN(F.silu(cond)).chunk(6, -1)
        h = self.attentionNorm(x) * (1 + scale1[:, None]) + shift1[:, None]
        x = x + self.attentionNorm1(gate1[:, None] * self.attention(
            h, allowed, self.attentionYNorm(yFeat), pos))
        h = self.ffnNorm(x) * (1 + scale2[:, None]) + shift2[:, None]
        return x + self.ffnNorm1(gate2[:, None] * self.ffn(h))


class Transformer(nn.Module):
    def __init__(self, canvas: int, dim: int, depth: int, heads: int, k: int, eps: float):
        super().__init__()
        self.tokenNorm = layerNorm(dim)
        self.tokenEmbed = nn.Linear(dim, dim)
        self.posEmbed = nn.Parameter(torch.zeros(canvas * canvas * 64, dim))
        self.capNorm, self.capCondNorm = layerNorm(dim), layerNorm(dim)
        self.capEmbed, self.capCondEmbed = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.blocks = nn.ModuleList([Block(dim, heads, eps) for _ in range(depth)])
        self.finalNorm = layerNorm(dim, affine=False)
        self.finalAdaLN = nn.Linear(dim, 2 * dim)
        self.finalLinear = nn.Linear(dim, k)

    def forward(self, tokens, allowed, condition):
        x = self.tokenEmbed(self.tokenNorm(tokens))
        pos = self.posEmbed[:x.shape[1]]
        cond = self.capEmbed(self.capNorm(condition))
        yFeat = self.capCondEmbed(self.capCondNorm(condition))[:, None]
        for block in self.blocks:
            x = block(x, allowed, cond, yFeat, pos)
        shift, scale = self.finalAdaLN(F.silu(cond)).chunk(2, -1)
        x = self.finalNorm(x) * (1 + scale[:, None]) + shift[:, None]
        return self.finalLinear(x)


class Generator(nn.Module):
    def __init__(self, channel: int, k: int, size: Sequence[int], hiddenSize: int, depth: int,
                 nHeads: int, numClasses: int, norm_eps: float = 1e-5):
        super().__init__()
        hs = hiddenSize
        self.size, self.numClasses = list(size), numClasses
        self.compressor = Neon(channel, k, size)
        self.classEmbed = nn.Parameter(torch.zeros(numClasses + 1, hs))
        self.scaffoldCodebook = nn.Parameter(torch.zeros(1, k, hs))
        ups = [nn.Identity()]
        for prev, this in zip(self.size, self.size[1:]):
            ups.append(UpConv(hs, hs) if this == prev // 2 else conv(hs, hs, 3))
        self._decoders = nn.ModuleList(ups)
        canvas = max(self.size)
        self.transformer = Transformer(canvas, hs, depth, nHeads, k, norm_eps)
        self.firstLevelPosEmbed = nn.Parameter(torch.zeros(canvas * canvas, hs))
        self.levelEmbed = nn.Parameter(torch.zeros(len(self.size), hs))
        self.capToFirstNorm = layerNorm(hs)
        self.capToFirst = nn.Linear(hs, hs)
        self.lengths = [s * s for s in sorted(self.size)]

    def blockCausal(self, device) -> torch.Tensor:
        """[T, T] bool: a token sees every earlier level and all of its own."""
        level = torch.cat([torch.full((n,), i, device=device) for i, n in enumerate(self.lengths)])
        return level[None, :] <= level[:, None]

    def sequence(self, codes: Sequence[torch.Tensor], condition: torch.Tensor) -> torch.Tensor:
        """Class ids [b] and codes small -> large -> the input tokens [b, T, hidden]."""
        b = condition.shape[0]
        canvas = max(self.size)
        side = math.isqrt(self.lengths[0])
        top = (canvas - side) // 2
        table = self.firstLevelPosEmbed.reshape(canvas, canvas, -1)
        first = table[top:top + side, top:top + side].reshape(side * side, -1)[None] \
            + self.capToFirst(self.capToFirstNorm(condition))[:, None] + self.levelEmbed[0]
        parts, former, L = [first.expand(b, -1, -1)], None, len(self.size)
        for level, code in enumerate(codes[:-1]):
            q = dequantize(code, self.scaffoldCodebook)
            former = self._decoders[L - 1 - level](q if former is None else q + former)
            parts.append(former.flatten(2).transpose(1, 2) + self.levelEmbed[level + 1])
        return torch.cat(parts, 1)

    def condition(self, classes: torch.Tensor) -> torch.Tensor:
        idx = torch.where(classes < 0, torch.full_like(classes, self.numClasses), classes)
        return self.classEmbed[idx.long()]

    def logits(self, codes: Sequence[torch.Tensor], classes: torch.Tensor) -> List[torch.Tensor]:
        """Teacher-forced logits of every level, small -> large, each [b, h*w, k]."""
        cond = self.condition(classes)
        seq = self.sequence(codes, cond)
        out = self.transformer(seq, self.blockCausal(seq.device), cond)
        return list(out.split(self.lengths, 1))
