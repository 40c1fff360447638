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
