"""Attention over the generator's [B, T, H, D] layout, plain PyTorch.

`flashAttentionPlain` is kernel K3's plain version (csrc/flash_attention.cu,
wrapper ops/attention_cuda.py) and what the CPU runs. It computes what
`mcquic_tpu/ops/attention_pallas.py::flashAttention` computes:
  * scores q.k in the inputs' precision (fp32 for fp32 and bf16 inputs),
    rounded to fp32, times `scale` (default 1/sqrt(D));
  * an optional mask [Tq, Tk] (nonzero = attend) added as (m - 1) * 1e9;
  * softmax in fp32, the probabilities cast to V's dtype before P.V;
  * the result in q's dtype.
A row whose keys are all masked stays finite, as in the kernel, but its
value means nothing; the block-causal mask has no such row.

The probabilities are normalized before P.V, as the generator's einsum path
(`mcquic_tpu/models/generator.py:112-127`) does; the kernel divides after.
In fp64 this reproduces the JAX package's fp32 rounding of scores and
probabilities at the same points.

`attentionPartialPlain` and `mergePartialsPlain` are the plain form of K3's
split route (flash-decoding): each split of the keys gives an unnormalized
accumulator and its rows' (max, sum), and the merge rescales them to a
common max.
"""
import math

import torch


def flashAttentionPlain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor = None, scale: float = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D], mask [Tq, Tk] or None -> [B, Tq, H, D]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)).float() * scale
    if mask is not None:
        scores = scores + (mask.to(scores.device, torch.float32) - 1.0) * 1e9
    probs = torch.softmax(scores, -1).to(v.dtype)
    accV = torch.promote_types(v.dtype, torch.float32)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(accV), v.to(accV)).to(q.dtype)


def attentionPartialPlain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor = None, scale: float = None):
    """One split of the keys: q [B, Tq, H, D], k/v [B, Tk', H, D], mask
    [Tq, Tk'] or None -> (acc [B, Tq, H, D], rowMax [B, H, Tq], rowSum
    [B, H, Tq]), acc = sum_j e^(s_j - rowMax) v_j and rowSum = sum_j
    e^(s_j - rowMax), in the inputs' precision. What a split of K3 writes to
    its scratch."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = scores + (mask.to(scores.device, scores.dtype) - 1.0) * 1e9
    rowMax = scores.amax(-1)
    probs = torch.exp(scores - rowMax[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), rowMax, probs.sum(-1)


def mergePartialsPlain(partials) -> torch.Tensor:
    """K3's merge of key splits, [(acc, rowMax, rowSum), ...] ->
    [B, Tq, H, D]:
        M = max_s m_s,  L = sum_s l_s e^(m_s - M),
        out = sum_s acc_s e^(m_s - M) / max(L, 1e-30)."""
    top = torch.stack([rowMax for _, rowMax, _ in partials]).amax(0)
    total, value = 0.0, 0.0
    for acc, rowMax, rowSum in partials:
        weight = torch.exp(rowMax - top)
        total = total + rowSum * weight
        value = value + acc * weight.permute(0, 2, 1)[..., None]
    return value / total.clamp_min(1e-30).permute(0, 2, 1)[..., None]
