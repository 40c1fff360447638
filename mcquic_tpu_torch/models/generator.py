"""The stage-2 next-scale generator, sampling half.

Counterpart of `mcquic_tpu/models/generator.py:47-538` (reference
`mcquic/modules/generator_3_self_attn.py` with the AnyRes transformer of
`generator_3.py`): a class-conditional transformer predicts the frozen Neon
tokenizer's codes level by level, small -> large, each level attending to
every token of the levels before it and all of its own (block-causal), then
Neon decodes the codes to an image.

Ported: `RMSNorm`, `SwiGLU`, `AnyResAttention`, `AnyResBlock`,
`AnyResTransformer`, `blockCausalMask` and `GeneratorV3SelfAttention` with
`generate` (KV-cached or not), `residual_forward`, the sequence assembly and
the teacher-forced training pass (`forward`, `generator.py:395-452`);
`useAda=False` is the NoAda ablation; `denseNorm` builds the tokenizer with
its GroupNorm blocks. With `textConditioned` (`generator.py:294-316`) the
condition is a precomputed caption embedding [n, capDim], projected by
`capProj` (a Linear to the hidden size) where the class table would be
read; the caption encoder itself (CLIP) runs outside the model.

Self-attention in sampling goes through `ops/attention_cuda.py::flashAttention`:
kernel K3 on CUDA, its plain version on the CPU. The KV-cached branch calls
it without a mask over the cached prefix, the other branch with the
block-causal mask. KV-cached sampling on a CUDA device with autograd off
runs each level's transformer pass from a CUDA graph (`LevelGraphs`): the
first such call for a batch size runs eagerly, the second captures one graph
per level, later calls replay them; the sampling between the passes stays
eager. K3 has no backward (nor has the JAX package's Pallas
kernel: it trains on einsums, `generator.py:119-128`), so the training pass
hands `ops/attention.py::flashAttentionPlain` down explicitly (`attend`).
With `remat`, each block of the training pass runs under
`torch.utils.checkpoint` (`nn.remat(AnyResBlock)`, `generator.py:242`). The
gated cross-attention to the single condition token stays plain torch.

Numerics follow the JAX package where it fixes a precision: RMSNorm,
attention scores and probabilities, and the final logits are fp32, and the
KV-cached path rounds scaffold tokens to fp32, whatever the model's dtype.
Every LayerNorm has flax's epsilon, 1e-6.
"""
import math
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mcquic_tpu_torch.models.compressor import Neon
from mcquic_tpu_torch.nn.convs import conv3x3, pixelShuffle3x3
from mcquic_tpu_torch.ops.attention import flashAttentionPlain
from mcquic_tpu_torch.ops import attention_cuda
from mcquic_tpu_torch.ops.attention_cuda import flashAttention
from mcquic_tpu_torch.ops.vq import vqDequantizeCodes
from mcquic_tpu_torch.utils import tracing
from mcquic_tpu_torch.utils.registry import GeneratorRegistry

IMAGENET_CLASSES = 1000
LAYER_NORM_EPS = 1e-6          # flax nn.LayerNorm's default


def layerNorm(dim: int, affine: bool = True) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LAYER_NORM_EPS, elementwise_affine=affine, bias=affine)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale, computed in fp32 (generator.py:53-62)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class SwiGLU(nn.Module):
    """w2(silu(w1 x) * w3 x) (generator.py:65-76)."""

    def __init__(self, dim: int, hiddenDim: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hiddenDim, bias=False)
        self.w2 = nn.Linear(hiddenDim, dim, bias=False)
        self.w3 = nn.Linear(dim, hiddenDim, bias=False)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)) * self.w3(x))


class AnyResAttention(nn.Module):
    """Self-attention with additive position embeddings and qk-norm, plus a
    tanh-gated cross-attention to the condition (generator.py:79-146)."""

    def __init__(self, dim: int, nHeads: int, qkNorm: bool = True):
        super().__init__()
        self.nHeads = nHeads
        self.qkNorm = qkNorm
        for name in ("wq", "wk", "wv", "wo", "wkY", "wvY"):
            setattr(self, name, nn.Linear(dim, dim, bias=False))
        if qkNorm:
            self.qNorm, self.kNorm, self.kyNorm = layerNorm(dim), layerNorm(dim), layerNorm(dim)
        self.gate = nn.Parameter(torch.zeros(nHeads))

    def forward(self, x, mask, yFeat, posEmbed, cache=None, offset: int = 0, attend=None):
        """x [bs, seq, dim]; mask [seq, seq] or None; yFeat [bs, yLen, dim];
        posEmbed [seq, dim]. With `cache`, a (k, v) pair of [bs, Lmax, H, hd]
        buffers, this level's keys and values are written into it in place at
        [offset, offset + seq) and the queries attend to the whole cached
        prefix without a mask. `attend` is the self-attention: K3's wrapper
        (None), or its plain version for a pass that needs gradients."""
        attend = attend or flashAttention
        bs, seq, dim = x.shape
        H = self.nHeads
        hd = dim // H
        xq, xk, xv = self.wq(x), self.wk(x), self.wv(x)
        if self.qkNorm:
            xq, xk = self.qNorm(xq), self.kNorm(xk)
        pos = posEmbed.reshape(1, seq, H, hd).to(xq.dtype)
        xq = xq.reshape(bs, seq, H, hd) + pos
        xk = xk.reshape(bs, seq, H, hd) + pos
        xv = xv.reshape(bs, seq, H, hd)
        scale = 1.0 / math.sqrt(hd)
        if cache is not None:
            ck, cv = cache
            ck[:, offset:offset + seq] = xk
            cv[:, offset:offset + seq] = xv
            out = attend(xq, ck[:, :offset + seq], cv[:, :offset + seq], None, scale)
        else:
            out = attend(xq, xk, xv, mask, scale)

        yLen = yFeat.shape[1]
        yk = self.wkY(yFeat)
        if self.qkNorm:
            yk = self.kyNorm(yk)
        yk = yk.reshape(bs, yLen, H, hd)
        yv = self.wvY(yFeat).reshape(bs, yLen, H, hd)
        yLogits = torch.einsum("bqhd,bkhd->bhqk", xq, yk).float() * scale
        yProbs = torch.softmax(yLogits, -1).to(x.dtype)
        yOut = torch.einsum("bhqk,bkhd->bqhd", yProbs, yv)
        yOut = yOut * torch.tanh(self.gate).to(x.dtype)[None, None, :, None]
        return self.wo((out + yOut).reshape(bs, seq, dim))


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


class AnyResBlock(nn.Module):
    """adaLN-modulated transformer block with an RMSNorm sandwich
    (generator.py:153-193); `useAda=False` drops the modulation."""

    def __init__(self, dim: int, nHeads: int, qkNorm: bool = True, normEps: float = 1e-5,
                 useAda: bool = True):
        super().__init__()
        self.useAda = useAda
        for name in ("attentionNorm", "attentionNorm1", "ffnNorm", "ffnNorm1", "attentionYNorm"):
            setattr(self, name, RMSNorm(dim, normEps))
        if useAda:
            self.adaLN = nn.Linear(dim, 6 * dim)
        self.attention = AnyResAttention(dim, nHeads, qkNorm)
        self.ffn = SwiGLU(dim, 4 * dim)

    def forward(self, x, mask, yEmb, yFeat, posEmbed, cache=None, offset: int = 0, attend=None):
        if self.useAda:
            sMsa, scMsa, gMsa, sMlp, scMlp, gMlp = self.adaLN(F.silu(yEmb)).chunk(6, -1)
            attnIn = _modulate(self.attentionNorm(x), sMsa, scMsa)
        else:
            attnIn = self.attentionNorm(x)
        attnOut = self.attention(attnIn, mask, self.attentionYNorm(yFeat), posEmbed, cache, offset,
                                 attend)
        if self.useAda:
            x = x + self.attentionNorm1(gMsa[:, None] * attnOut)
            ffnOut = self.ffn(_modulate(self.ffnNorm(x), sMlp, scMlp))
            return x + self.ffnNorm1(gMlp[:, None] * ffnOut)
        x = x + self.attentionNorm1(attnOut)
        return x + self.ffnNorm1(self.ffn(self.ffnNorm(x)))


class AnyResTransformer(nn.Module):
    """Token embedding, a learned position table of canvas^2 * 64 rows, the
    blocks, and the final (adaLN) layer to k logits (generator.py:196-266)."""

    def __init__(self, canvasSize: int, hiddenSize: int, depth: int, nHeads: int,
                 vocabSize: int, qkNorm: bool = True, normEps: float = 1e-5, useAda: bool = True):
        super().__init__()
        hs = hiddenSize
        self.useAda = useAda
        self.tokenNorm = layerNorm(hs)
        self.tokenEmbed = nn.Linear(hs, hs)
        self.posEmbed = nn.Parameter(torch.zeros(canvasSize * canvasSize * 64, hs))
        self.capNorm, self.capCondNorm = layerNorm(hs), layerNorm(hs)
        self.capEmbed, self.capCondEmbed = nn.Linear(hs, hs), nn.Linear(hs, hs)
        self.blocks = nn.ModuleList([AnyResBlock(hs, nHeads, qkNorm, normEps, useAda)
                                     for _ in range(depth)])
        self.finalNorm = layerNorm(hs, affine=False)
        if useAda:
            self.finalAdaLN = nn.Linear(hs, 2 * hs)
        self.finalLinear = nn.Linear(hs, vocabSize)

    def forward(self, tokens, mask, capPooled, capCond, caches=None, offset: int = 0,
                attend=None, remat: bool = False):
        """tokens [bs, L, hidden] -> fp32 logits [bs, L, k]. With `caches`
        (one (k, v) pair per block) the tokens are one level's, starting at
        position `offset` of the full sequence. `remat` checkpoints each
        block (a pass without caches)."""
        x = self.tokenEmbed(self.tokenNorm(tokens))
        # the JAX package stops the table's gradient (generator.py:226)
        posEmbed = self.posEmbed.detach()[offset:offset + x.shape[1]]
        capEmb = self.capEmbed(self.capNorm(capPooled))
        yFeat = self.capCondEmbed(self.capCondNorm(capCond))[:, None]
        for i, block in enumerate(self.blocks):
            if remat and caches is None:
                x = checkpoint(block, x, mask, capEmb, yFeat, posEmbed, None, offset, attend,
                               use_reentrant=False)
            else:
                x = block(x, mask, capEmb, yFeat, posEmbed,
                          None if caches is None else caches[i], offset, attend)
        x = self.finalNorm(x)
        if self.useAda:
            shift, scale = self.finalAdaLN(F.silu(capEmb)).chunk(2, -1)
            x = _modulate(x, shift, scale)
        return F.linear(x.float(), self.finalLinear.weight.float(), self.finalLinear.bias.float())


def blockCausalMask(lengths: Sequence[int]) -> np.ndarray:
    """Lower-triangular, plus full blocks on the diagonal (generator.py:269-279)."""
    total = sum(lengths)
    m = np.tril(np.ones((total, total), np.float32))
    cur = 0
    for length in lengths:
        m[cur:cur + length, cur:cur + length] = 1.0
        cur += length
    return m


def topKFilter(logits: torch.Tensor, topK: int) -> torch.Tensor:
    """Logits below the topK-th largest become -1e9 (generator.py:484-485)."""
    kth = torch.sort(logits, -1).values[..., -topK, None]
    return torch.where(logits < kth, torch.full_like(logits, -1e9), logits)


def graphsEngage(device: torch.device, kvCache: bool) -> bool:
    """Whether a sampling call runs its levels from CUDA graphs: KV-cached,
    on a CUDA device, with autograd recording nothing."""
    return kvCache and device.type == "cuda" and not torch.is_grad_enabled()


class LevelGraphs:
    """The KV-cached loop's buffers and graphs for one batch size, device,
    dtype and set of TF32 flags.

    The caches, the condition, each level's input tokens and (once
    captured) its logits live in fixed buffers; a call copies its inputs in.
    The caches are never zeroed again: a level reads only the prefix its
    call has written. The first call runs every level eagerly (warming
    cuBLAS and K3's plans), the second captures each level's transformer
    pass, every block, the final norm and the logits, into a graph of its
    own, every graph in the first one's memory pool, and replays it; later
    calls replay. A replay adds to `flashAttention.launches` the K3 launches
    its capture made, which the capture itself does not count. Two calls
    that share these buffers must not run at once (one model, one batch
    size, two threads)."""

    def __init__(self, model: "GeneratorV3SelfAttention", bs: int, device: torch.device):
        hs, hd = model.hiddenSize, model.hiddenSize // model.nHeads
        # plain tensors, so that calls under no_grad may write them as well
        # as calls under inference_mode
        with torch.inference_mode(False):
            def buffer(*shape):
                return torch.zeros(shape, dtype=model.dtype, device=device)
            self.caches = [(buffer(bs, sum(model.lengths), model.nHeads, hd),
                            buffer(bs, sum(model.lengths), model.nHeads, hd))
                           for _ in range(model.depth)]
            self.cap = buffer(bs, hs)
            self.tokens = [buffer(bs, hw, hs) for hw in model.lengths]
        levels = len(model.lengths)
        self.logits: List[Optional[torch.Tensor]] = [None] * levels
        self.graphs: list = [None] * levels
        self.k3 = [0] * levels
        self.warm = False
        self.pool = None

    def run(self, transformer: nn.Module, level: int, offset: int,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """Level `level`'s fp32 logits from its tokens, and whether a graph
        gave them."""
        self.tokens[level].copy_(tokens)

        def forward():
            return transformer(self.tokens[level], None, self.cap, self.cap, self.caches, offset)
        if not self.warm:
            return forward(), False
        if self.graphs[level] is None:
            k3 = attention_cuda.flashAttention
            before = k3.launches
            self.graphs[level], self.logits[level] = self._capture(forward)
            # the captured launches have not run: each replay counts them
            self.k3[level], k3.launches = k3.launches - before, before
        self.graphs[level].replay()
        attention_cuda.flashAttention.launches += self.k3[level]
        return self.logits[level], True

    def _capture(self, forward: Callable[[], torch.Tensor]):
        """(graph, its output): `forward` captured, nothing run."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            out = forward()
        if self.pool is None:
            self.pool = graph.pool()
        return graph, out


class LevelGraphCache:
    """A generator's `LevelGraphs` by (batch size, device, dtype, TF32
    flags), the last `KEPT` used, all for the transformer's parameters at
    the storage they had at capture: when a parameter's storage moves
    (`.to`, `load_state_dict(..., assign=True)`) every entry goes, so no
    graph reads freed memory. A copy or a pickle of the model starts empty."""
    KEPT = 4

    def __init__(self):
        self.weights: Tuple[int, ...] = ()
        self.entries: "OrderedDict[tuple, LevelGraphs]" = OrderedDict()

    def __reduce__(self):
        return type(self), ()

    def get(self, model: "GeneratorV3SelfAttention", bs: int, device: torch.device) -> LevelGraphs:
        weights = tuple(p.data_ptr() for p in model.transformer.parameters())
        if weights != self.weights:
            self.entries.clear()
            self.weights = weights
        key = (bs, device, model.dtype, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        entry = self.entries.pop(key, None) or LevelGraphs(model, bs, device)
        self.entries[key] = entry
        while len(self.entries) > self.KEPT:
            self.entries.popitem(last=False)
        return entry


@GeneratorRegistry.register
class GeneratorV3SelfAttention(nn.Module):
    """Class-conditional next-scale generator over a frozen Neon
    (generator.py:282-529). `size` lists Neon's latent grids large -> small;
    a class id of -1 (or numClasses) picks the null embedding. With
    `textConditioned` the condition is a float caption embedding [n,
    capDim] instead of class ids."""

    def __init__(self, channel: int, k: int, size: Sequence[int], qk_norm: bool = True,
                 norm_eps: float = 1e-5, hiddenSize: int = 1536, depth: int = 24,
                 nHeads: int = 16, numClasses: int = IMAGENET_CLASSES, useAda: bool = True,
                 remat: bool = False, denseNorm: bool = False, textConditioned: bool = False,
                 capDim: int = 512):
        super().__init__()
        self.k = k
        self.remat = remat
        self.size = list(size)
        self.hiddenSize = hs = hiddenSize
        self.depth = depth
        self.nHeads = nHeads
        self.numClasses = numClasses
        self.textConditioned = textConditioned
        self.capDim = capDim
        self.compressor = Neon(channel, k, self.size, useRemat=False, denseNorm=denseNorm)
        if textConditioned:
            self.capProj = nn.Linear(capDim, hs)
        else:
            self.classEmbed = nn.Parameter(torch.zeros(numClasses + 1, hs))
        self.scaffoldCodebook = nn.Parameter(torch.zeros(1, k, hs))
        # Construction order (large -> small), as in Neon. Level 0 (the
        # largest) would only turn the last codes into features no level
        # reads, so it is never run and has no weights.
        decoders = [nn.Identity()]
        lastSize = self.size[0]
        for thisSize in self.size[1:]:
            if thisSize == lastSize // 2:
                decoders.append(pixelShuffle3x3(hs, hs, 2))
            elif thisSize == lastSize:
                decoders.append(conv3x3(hs, hs))
            else:
                raise ValueError("size sequence must halve or repeat")
            lastSize = thisSize
        self._decoders = nn.ModuleList(decoders)
        canvas = max(self.size)
        self.transformer = AnyResTransformer(canvas, hs, depth, nHeads, k, qk_norm, norm_eps,
                                             useAda)
        self.firstLevelPosEmbed = nn.Parameter(torch.zeros(canvas * canvas, hs))
        self.levelEmbed = nn.Parameter(torch.zeros(len(self.size), hs))
        self.capToFirstNorm = layerNorm(hs)
        self.capToFirst = nn.Linear(hs, hs)
        self.lengths = [s * s for s in sorted(self.size)]
        self.register_buffer("_mask", torch.from_numpy(blockCausalMask(self.lengths))
                             .to(torch.int8), persistent=False)
        self._graphs = LevelGraphCache()

    @property
    def dtype(self) -> torch.dtype:
        return self.levelEmbed.dtype

    def residual_forward(self, code: torch.Tensor, formerLevel, level: int) -> torch.Tensor:
        """The generator's own feature pyramid (generator.py:351-358): code
        [n, 1, h, w], level 0 = smallest -> features [n, hidden, h', w']."""
        quantized = vqDequantizeCodes(code, self.scaffoldCodebook)
        if formerLevel is not None:
            quantized = quantized + formerLevel
        return self._decoders[len(self.size) - 1 - level](quantized)

    def _centerPosEmbed(self, h: int, w: int) -> torch.Tensor:
        canvas = max(self.size)
        table = self.firstLevelPosEmbed.reshape(canvas, canvas, -1)
        top, left = (canvas - h) // 2, (canvas - w) // 2
        return table[top:top + h, left:left + w].reshape(h * w, -1)

    def _firstLevelTokens(self, capPooled: torch.Tensor) -> torch.Tensor:
        """[bs, hw0, hidden]: the canvas-centred position crop plus the
        condition, plus level 0's embedding."""
        side = math.isqrt(self.lengths[0])
        first = self._centerPosEmbed(side, side)[None] \
            + self.capToFirst(self.capToFirstNorm(capPooled))[:, None]
        return first + self.levelEmbed[0]

    @staticmethod
    def _tokens(feat: torch.Tensor) -> torch.Tensor:
        """NCHW features -> [n, h*w, c] tokens in row-major (h, w) order."""
        return feat.flatten(2).transpose(1, 2)

    def _assembleSequence(self, scaffolds: Sequence[torch.Tensor], capPooled: torch.Tensor,
                          bs: int) -> torch.Tensor:
        """Level 0's tokens, then each scaffold's (levels 1..), concatenated
        (generator.py:367-383)."""
        first = self._firstLevelTokens(capPooled)
        parts = [first] + [(self._tokens(feat) + self.levelEmbed[level]).to(first.dtype)
                           for level, feat in enumerate(scaffolds, start=1)]
        return torch.cat([p.expand(bs, *p.shape[1:]) for p in parts], 1)

    def _condEmbed(self, condition: torch.Tensor) -> torch.Tensor:
        """Class ids [bs] -> pooled condition [bs, hidden]; -1 is the null
        class. A text-conditioned model projects caption embeddings [bs,
        capDim] instead (`generator.py:385-391`)."""
        if self.textConditioned:
            return self.capProj(condition.to(self.dtype))
        idx = torch.where(condition < 0, torch.full_like(condition, self.numClasses), condition)
        return self.classEmbed[idx.long()]

    def forward(self, image: torch.Tensor, condition: torch.Tensor, preview: bool = False):
        """Teacher-forced training pass (`generator.py:395-452`): image
        [n, 3, H, W] in [-1, 1], condition [n] class ids -> (per-level logits
        small -> large [n, h, w, k] fp32, the scalar loss, the frozen
        tokenizer's codes [n, 1, h, w], the greedy preview [n, 3, H, W] or
        None, the per-level mean CE).

        The frozen Neon encodes in its own precision (fp32 in training)
        under `torch.no_grad()`, K1 once per level on CUDA. The loss is the
        label-smoothed (0.1) CE of every token, summed per level weighted by
        its area, over batch x (tokens + 1). The preview decodes the greedy
        codes through the frozen decoder; the JAX step drops it as dead code,
        so it runs only with `preview`."""
        with torch.no_grad():
            codes = self.compressor.encode(image.to(self.compressor._quantizer.codebook.dtype))
        expect = sorted(self.size)
        for lv, code in enumerate(codes):
            if code.shape[2] != expect[lv] or code.shape[3] != expect[lv]:
                raise ValueError(
                    f"config size {tuple(self.size)} does not match the tokenizer: level {lv} code "
                    f"grid is {code.shape[2]}x{code.shape[3]}, expected {expect[lv]}x{expect[lv]} "
                    f"for input {image.shape[2]}x{image.shape[3]} (input -> latent is /8 and "
                    f"size[0] must equal latent/2, e.g. 256 -> 16)")
        scaffolds, former = [], None
        for level, code in enumerate(codes[:-1]):
            former = self.residual_forward(code, former, level)
            scaffolds.append(former)
        bs = image.shape[0]
        capPooled = self._condEmbed(condition)
        seq = self._assembleSequence([s.to(self.dtype) for s in scaffolds], capPooled, bs)
        # K3 has no backward: the training pass attends through the plain version
        logits = self.transformer(seq, self._mask, capPooled, capPooled, attend=flashAttentionPlain,
                                  remat=self.remat and self.training and torch.is_grad_enabled())
        predictions, perLevel, total, cur = [], [], 0.0, 0
        smooth = 0.1
        for code in codes:
            n, _, h, w = code.shape
            pre = logits[:, cur:cur + h * w]
            predictions.append(pre.reshape(n, h, w, self.k))
            logp = torch.log_softmax(pre, -1)
            gt = code.reshape(n, h * w, 1).long()
            nll = -(1 - smooth) * torch.gather(logp, -1, gt)[..., 0] - smooth * logp.mean(-1)
            total = total + h * w * nll.sum()
            perLevel.append(nll.mean())
            cur += h * w
        loss = total / bs / (cur + 1)
        restored = None
        if preview:
            with torch.no_grad():
                restored = self.compressor.decode(
                    [p.argmax(-1)[:, None].to(torch.int32) for p in predictions])
        return predictions, loss, codes, restored, perLevel

    def generate(self, condition: torch.Tensor, generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, topK: int = 0, kvCache: bool = True,
                 gumbel: Optional[Callable] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Next-scale sampling (generator.py:454-529): `sampleCodes`, then
        Neon's decode. Returns (codes small -> large, each [bs, 1, h, w]
        int32; the restored image [bs, 3, H, W] in [-1, 1])."""
        codes = self.sampleCodes(condition, generator, temperature, topK, kvCache, gumbel)
        return codes, self.compressor.decode(codes)

    def sampleCodes(self, condition: torch.Tensor, generator: Optional[torch.Generator] = None,
                    temperature: float = 1.0, topK: int = 0, kvCache: bool = True,
                    gumbel: Optional[Callable] = None) -> List[torch.Tensor]:
        """The codes of every level, small -> large, each [bs, 1, h, w] int32.
        With no `generator` and no `gumbel`, decoding is greedy (argmax);
        with a generator, each level is drawn from softmax(logits /
        temperature), cut to the topK largest when topK > 0; with `gumbel`
        (shape -> Gumbel noise), each level is argmax of those filtered
        logits plus the noise, which is `jax.random.categorical` when both
        are handed the same noise. `kvCache=True` runs each level's tokens
        only, with the keys and values of earlier levels cached;
        `kvCache=False` reruns the whole prefix under the block-causal mask
        (the equivalence oracle).

        KV-cached calls on a CUDA device with autograd off run each level's
        transformer pass from a CUDA graph from their batch size's third
        call on (`LevelGraphs`), with the same kernels in the same order.

        While `torch.profiler` records, each call leaves one span,
        `generator.sampleCodes` (`utils/tracing.py`), with the batch's
        `images` and `tokens` (its images times the tokens of one), the
        `levels` it ran and how many of them were `replayed` from a graph:
        it ends when the loop is enqueued, with no synchronize."""
        with tracing.span("generator.sampleCodes", images=condition.shape[0],
                          tokens=condition.shape[0] * sum(self.lengths)) as record:
            codes, replayed = self._sampleCodes(condition, generator, temperature, topK, kvCache,
                                                gumbel)
            if record is not None:
                record.counts.update(levels=len(self.lengths), replayed=replayed)
            return codes

    def _sampleCodes(self, condition, generator, temperature, topK, kvCache, gumbel):
        """(the codes, the number of levels replayed from a graph)."""
        bs = condition.shape[0]
        capPooled = self._condEmbed(condition)
        hd = self.hiddenSize // self.nHeads
        total = sum(self.lengths)
        caches = graphs = None
        if graphsEngage(capPooled.device, kvCache):
            graphs = self._graphs.get(self, bs, capPooled.device)
            graphs.cap.copy_(capPooled)
        elif kvCache:
            caches = [tuple(torch.zeros((bs, total, self.nHeads, hd), dtype=self.dtype,
                                        device=capPooled.device) for _ in range(2))
                      for _ in range(self.depth)]

        predictions, scaffolds = [], []
        former = None
        offset = replayed = 0
        for level, hw in enumerate(self.lengths):
            if kvCache:
                if level == 0:
                    tok = self._firstLevelTokens(capPooled).expand(bs, hw, -1)
                else:
                    tok = (self._tokens(former) + self.levelEmbed[level]).float()
                if graphs is None:
                    levelLogits = self.transformer(tok.to(self.dtype), None, capPooled, capPooled,
                                                   caches, offset)
                else:
                    levelLogits, fromGraph = graphs.run(self.transformer, level, offset, tok)
                    replayed += fromGraph
            else:
                seq = self._assembleSequence(scaffolds, capPooled, bs)
                prefix = seq.shape[1]
                logits = self.transformer(seq, self._mask[:prefix, :prefix], capPooled,
                                          capPooled)
                levelLogits = logits[:, prefix - hw:]
            if generator is None and gumbel is None:
                token = levelLogits.argmax(-1)
            else:
                scaled = levelLogits / max(temperature, 1e-6)
                if topK > 0:
                    scaled = topKFilter(scaled, topK)
                if gumbel is not None:
                    token = (scaled + gumbel(tuple(scaled.shape)).to(scaled)).argmax(-1)
                else:
                    probs = torch.softmax(scaled, -1).reshape(bs * hw, -1)
                    token = torch.multinomial(probs, 1, generator=generator)
            side = math.isqrt(hw)
            code = token.reshape(bs, 1, side, side).to(torch.int32)
            predictions.append(code)
            offset += hw
            if level < len(self.lengths) - 1:
                former = self.residual_forward(code, former, level)
                scaffolds.append(former)
        if graphs is not None:
            graphs.warm = True
        return predictions, replayed


@GeneratorRegistry.register
class GeneratorV3SelfAttentionNoAda(GeneratorV3SelfAttention):
    """The ablation without adaLN (generator.py:532-538): sandwich-norm
    blocks and a plain final norm + linear."""

    def __init__(self, *args, useAda: bool = False, **kwargs):
        super().__init__(*args, useAda=useAda, **kwargs)
