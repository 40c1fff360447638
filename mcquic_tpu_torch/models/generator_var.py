"""The VAR-style next-scale generator with KV-cached classifier-free-guidance
sampling.

Counterpart of `mcquic_tpu/models/generator_var.py` (reference
`mcquic/modules/generator_3_var.py:595-883`), one module for each of its
modules, under the same names: `VARAttention` (`qkv`, `proj`, the l2 qk-norm
with its learned `scaleLogit`, an external KV cache), `VARBlock` (the 6-way
`adaLN` around a pre-norm attention and GELU MLP), `levelCausalBias` and
`GeneratorVAR` over a frozen port `Neon`. Its scaffold tokens are Neon's own
`residual_forward` features (8 channels), as in the JAX package's repair of
the reference.

Attention:
  * sampling (`generate`) attends through
    `ops/attention_cuda.py::flashAttention`, kernel K3 on CUDA, its plain
    version on the CPU: the queries of one level against the whole cached
    prefix, no mask, scale 1.0 under `attnL2Norm` (the norm and the learned
    scale are in q and k already), 1/sqrt(head dim) otherwise. The JAX
    package runs an einsum there (`generator_var.py:79-83`);
  * the teacher-forced training pass attends through the plain version with
    the level-causal mask: K3 has no backward.

Numerics follow the JAX package where it fixes a precision: the attention
scores and probabilities are fp32, and the head rounds its input to fp32
and projects to fp32 logits, whatever the model's dtype. The LayerNorms have no
affine parameters and flax's epsilon; GELU is flax's tanh approximation.

Random draws come from the caller: the training pass takes `draw` (shape ->
uniforms) for the condition drop, and `generate` takes `gumbel` (shape ->
Gumbel noise) and samples argmax(logits + noise), which is
`jax.random.categorical` when both are handed the same noise. Without
`gumbel`, the noise is drawn from `generator`.
"""
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mcquic_tpu_torch.models.compressor import Neon
from mcquic_tpu_torch.ops.attention import flashAttentionPlain
from mcquic_tpu_torch.ops.attention_cuda import flashAttention
from mcquic_tpu_torch.utils.registry import GeneratorRegistry

IMAGENET_CLASSES = 1000
NORM_EPS = 1e-6                 # the JAX package's normEps and flax's LayerNorm default


def _layerNorm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


class VARAttention(nn.Module):
    """Self-attention with an optional l2 qk-norm and an external KV cache
    (`generator_var.py:39-88`)."""

    def __init__(self, dim: int, nHeads: int, attnL2Norm: bool = True):
        super().__init__()
        self.nHeads = nHeads
        self.attnL2Norm = attnL2Norm
        self.qkv = nn.Linear(dim, 3 * dim)
        if attnL2Norm:
            self.scaleLogit = nn.Parameter(torch.full((nHeads, 1, 1), math.log(4.0)))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, cache=None,
                offset: int = 0) -> torch.Tensor:
        """x [B, l, C]. `mask` [l, l] (nonzero = attend): the training pass,
        plain attention. `cache`: a (k, v) pair of [B, Lmax, H, hd] buffers,
        this call's keys and values written in place at [offset, offset + l),
        the queries attending to the whole prefix through K3."""
        B, l, C = x.shape
        H = self.nHeads
        hd = C // H
        q, k, v = self.qkv(x).reshape(B, l, 3, H, hd).unbind(2)
        if self.attnL2Norm:
            q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-6)
            k = k / torch.clamp_min(torch.linalg.vector_norm(k, dim=-1, keepdim=True), 1e-6)
            q = q * torch.exp(self.scaleLogit).reshape(1, 1, H, 1)
            scale = 1.0
        else:
            scale = 1.0 / math.sqrt(hd)
        if cache is not None:
            ck, cv = cache
            ck[:, offset:offset + l] = k
            cv[:, offset:offset + l] = v
            out = flashAttention(q, ck[:, :offset + l], cv[:, :offset + l], None, scale)
        else:
            out = flashAttentionPlain(q, k, v, mask, scale)
        return self.proj(out.reshape(B, l, C))


class VARBlock(nn.Module):
    """`AdaLNSelfAttn` (`generator_var.py:91-117`): the condition's 6-way
    adaLN gates, shifts and scales around a pre-norm attention and a GELU
    MLP."""

    def __init__(self, dim: int, nHeads: int, mlpRatio: float = 4.0, normEps: float = NORM_EPS,
                 attnL2Norm: bool = True):
        super().__init__()
        self.normEps = normEps
        self.adaLN = nn.Linear(dim, 6 * dim)
        self.attn = VARAttention(dim, nHeads, attnL2Norm)
        hidden = int(dim * mlpRatio)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, cond, mask=None, cache=None, offset: int = 0):
        g1, g2, s1, s2, sc1, sc2 = self.adaLN(F.silu(cond)).chunk(6, -1)
        h = _layerNorm(x, self.normEps) * (1 + sc1[:, None]) + s1[:, None]
        x = x + g1[:, None] * self.attn(h, mask, cache, offset)
        h = _layerNorm(x, self.normEps) * (1 + sc2[:, None]) + s2[:, None]
        h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
        return x + g2[:, None] * h


def levelCausalBias(patchNums: Sequence[int]) -> np.ndarray:
    """0 where a token may attend, -inf where not: every token sees the
    tokens of its own level and of the levels before it
    (`generator_var.py:120-125`)."""
    d = np.concatenate([np.full(pn * pn, i) for i, pn in enumerate(patchNums)])
    return np.where(d[:, None] >= d[None, :], 0.0, -np.inf).astype(np.float32)


def filterLogits(logits: torch.Tensor, topK: int, topP: float) -> torch.Tensor:
    """`GeneratorVAR._filterLogits` (`generator_var.py:287-302`): logits
    below the topK-th largest become -1e9; then, in the order of falling
    logits, every logit after the probability mass has reached topP."""
    if topK and topK > 0:
        kth = torch.sort(logits, -1).values[..., -topK, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e9), logits)
    if topP and 0.0 < topP < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        sortedLogits = torch.gather(logits, -1, order)
        probs = torch.softmax(sortedLogits, -1)
        keepSorted = torch.cumsum(probs, -1) - probs < topP
        keep = torch.zeros_like(keepSorted).scatter(-1, order, keepSorted)
        logits = torch.where(keep, logits, torch.full_like(logits, -1e9))
    return logits


@GeneratorRegistry.register
class GeneratorVAR(nn.Module):
    """A frozen Neon tokenizer and a VAR transformer over its codes
    (`generator_var.py:128-284`). `size` lists Neon's latent grids large ->
    small; the transformer runs its levels small -> large (`patchNums`). A
    class id of `numClasses` is the null class of the guidance."""

    def __init__(self, channel: int, k: int, size: Sequence[int], depth: int = 24,
                 embedDim: int = 1536, nHeads: int = 16, numClasses: int = IMAGENET_CLASSES,
                 condDropRate: float = 0.1, normEps: float = NORM_EPS, attnL2Norm: bool = True,
                 denseNorm: bool = False):
        super().__init__()
        self.k = k
        self.size = list(size)
        self.depth = depth
        self.embedDim = C = embedDim
        self.nHeads = nHeads
        self.numClasses = numClasses
        self.condDropRate = condDropRate
        self.normEps = normEps
        self.attnL2Norm = attnL2Norm
        self.compressor = Neon(channel, k, self.size, useRemat=False, denseNorm=denseNorm)
        self.patchNums = sorted(self.size)
        self.lengths = [pn * pn for pn in self.patchNums]
        self.L = sum(self.lengths)
        self.firstL = self.lengths[0]
        self.wordEmbed = nn.Linear(self.compressor._quantizer.channel, C)
        self.classEmb = nn.Parameter(torch.zeros(numClasses + 1, C))
        self.posStart = nn.Parameter(torch.zeros(1, self.firstL, C))
        self.pos1LC = nn.Parameter(torch.zeros(1, self.L, C))
        self.lvlEmbed = nn.Parameter(torch.zeros(len(self.patchNums), C))
        self.blocks = nn.ModuleList([VARBlock(C, nHeads, 4.0, normEps, attnL2Norm)
                                     for _ in range(depth)])
        self.headAda = nn.Linear(C, 2 * C)
        self.head = nn.Linear(C, k)
        levels = np.concatenate([np.full(n, i) for i, n in enumerate(self.lengths)])
        self.register_buffer("_lvlIdx", torch.from_numpy(levels).long(), persistent=False)
        self.register_buffer("_mask", torch.from_numpy(
            (levelCausalBias(self.patchNums) == 0).astype(np.int8)), persistent=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.lvlEmbed.dtype

    def _levelPositions(self) -> torch.Tensor:
        """[L, C]: each token's level embedding plus its position."""
        return self.lvlEmbed[self._lvlIdx] + self.pos1LC[0]

    def _logits(self, h: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The adaLN head: the tokens rounded to fp32 and normalized, fp32
        logits [B, l, k] (`generator_var.py:174-177`)."""
        shift, scale = self.headAda(F.silu(cond)).chunk(2, -1)
        h = _layerNorm(h.float().to(self.dtype), self.normEps) * (1 + scale[:, None]) \
            + shift[:, None]
        return F.linear(h.float(), self.head.weight.float(), self.head.bias.float())

    def _tokens(self, feat: torch.Tensor) -> torch.Tensor:
        """Neon features [n, 8, h, w] -> embedded tokens [n, h*w, C], row-major."""
        return self.wordEmbed(feat.flatten(2).transpose(1, 2).to(self.dtype))

    # -------------------------------------------------------------- training
    def forward(self, image: torch.Tensor, condition: torch.Tensor,
                draw: Optional[Callable] = None, preview: bool = False):
        """Teacher-forced pass (`generator_var.py:179-232`): image
        [B, 3, H, W] in [-1, 1], class ids [B] -> (logits [B, L, k] fp32, the
        mean CE over B x L tokens, Neon's codes small -> large [B, 1, h, w],
        the greedy preview [B, 3, H, W] or None, the per-level mean CE).

        With `draw`, each condition becomes the null class where its uniform
        (`draw((B,))`) is below `condDropRate`, the guidance's training;
        without, every condition stays (the JAX package's `train=False`).
        The frozen Neon encodes under `torch.no_grad()`, K1 once per level on
        CUDA. The preview decodes the greedy codes through the frozen
        decoder; the JAX step drops it as dead code, so it runs only with
        `preview`."""
        with torch.no_grad():
            codes = self.compressor.encode(image.to(self.compressor._quantizer.codebook.dtype))
            scaffolds, former = [], None
            for level, code in enumerate(codes[:-1]):
                former = self.compressor.residual_forward(code, former, level)
                scaffolds.append(former)
        B = image.shape[0]
        if draw is not None:
            drop = draw((B,)) < self.condDropRate
            condition = torch.where(drop, torch.full_like(condition, self.numClasses), condition)
        cond = self.classEmb[condition.long()]
        x = torch.cat([(cond[:, None] + self.posStart)]
                      + [self._tokens(feat) for feat in scaffolds], 1)
        x = x + self._levelPositions()
        for block in self.blocks:
            x = block(x, cond, self._mask)
        logits = self._logits(x, cond)
        total, perLevel, cur = 0.0, [], 0
        for code in codes:
            n = code[0, 0].numel()
            nll = -torch.gather(torch.log_softmax(logits[:, cur:cur + n], -1), -1,
                                code.reshape(B, n, 1).long())[..., 0]
            total = total + nll.sum()
            perLevel.append(nll.mean())
            cur += n
        loss = total / (B * self.L)
        restored = None
        if preview:
            with torch.no_grad():
                greedy, cur = [], 0
                for code in codes:
                    n = code[0, 0].numel()
                    greedy.append(logits[:, cur:cur + n].argmax(-1).reshape(code.shape)
                                  .to(torch.int32))
                    cur += n
                restored = self.compressor.decode(greedy)
        return logits, loss, codes, restored, perLevel

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def generate(self, condition: torch.Tensor, generator: Optional[torch.Generator] = None,
                 cfg: float = 1.5, topK: int = 0, topP: float = 0.0,
                 gumbel: Optional[Callable] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """KV-cached CFG sampling (`generator_var.py:235-284`): `sampleCodes`,
        then Neon's decode. Returns (codes small -> large, each [B, 1, h, w]
        int32; the restored image [B, 3, H, W] in [-1, 1])."""
        codes = self.sampleCodes(condition, generator, cfg, topK, topP, gumbel)
        return codes, self.compressor.decode(codes)

    @torch.no_grad()
    def sampleCodes(self, condition: torch.Tensor, generator: Optional[torch.Generator] = None,
                    cfg: float = 1.5, topK: int = 0, topP: float = 0.0,
                    gumbel: Optional[Callable] = None) -> List[torch.Tensor]:
        """The codes of class ids [B], level by level. The batch runs doubled,
        the conditions and then the null class; level si's logits are guided
        with t = cfg * si / (S - 1), (1 + t) cond - t null, filtered
        (`filterLogits`), and sampled as argmax(logits + Gumbel noise): the
        noise of `gumbel(shape)` or, by default, -log(-log(u)) of uniforms
        drawn from `generator`. Every attention call is K3 on CUDA: depth x
        levels launches."""
        if gumbel is None:
            def gumbel(shape):
                u = torch.rand(shape, generator=generator, device=condition.device)
                return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))
        B = condition.shape[0]
        hd = self.embedDim // self.nHeads
        labels = torch.cat([condition.long(), torch.full_like(condition.long(), self.numClasses)])
        cond = self.classEmb[labels]
        caches = [tuple(torch.zeros((2 * B, self.L, self.nHeads, hd), dtype=self.dtype,
                                    device=cond.device) for _ in range(2))
                  for _ in range(self.depth)]
        positions = self._levelPositions()
        x = cond[:, None] + self.posStart + positions[None, :self.firstL]
        S = len(self.patchNums)
        offset, former, predictions = 0, None, []
        for si, pn in enumerate(self.patchNums):
            for block, cache in zip(self.blocks, caches):
                x = block(x, cond, None, cache, offset)
            logits = self._logits(x, cond)
            t = cfg * si / max(S - 1, 1)
            guided = filterLogits((1 + t) * logits[:B] - t * logits[B:], topK, topP)
            noise = gumbel(tuple(guided.shape)).to(guided.device, guided.dtype)
            code = (guided + noise).argmax(-1).reshape(B, 1, pn, pn).to(torch.int32)
            predictions.append(code)
            offset += pn * pn
            if si < S - 1:
                former = self.compressor.residual_forward(code, former, si)
                nxt = self._tokens(former) + positions[offset:offset + self.lengths[si + 1]]
                x = torch.cat([nxt, nxt], 0)
        return predictions

