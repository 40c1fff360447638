"""The training step, the dead-codeword refresh and the code usage
(counterpart of `mcquic_tpu/train/state.py`, reference
`mcquic/train/trainer.py:67-305`).

One step (`makeTrainStep`, `state.py:39-90`): the forward in training mode
(which moves `freqEMA` toward the batch's code counts), the loss
0.5 distortion + 0.5 mse + 2 lpips, its gradients, their global norm, the
gradients scaled to a norm of at most 4.0, and the optimizer's update. A
step whose loss or gradient norm is not finite is skipped whole: the
parameters, the optimizer's state and `freqEMA` stay as they were. The
metrics carry the JAX step's keys.

Under data parallelism (`parallel`) each rank runs the step on its slice of
the global batch: right after the backward the gradients and the four loss
terms are averaged over the ranks in one flat buffer (`averageOverRanks`),
and the norm, the clip, the non-finite decision and the update follow from
those averages, so every rank takes the same step, or skips it.
"""
from typing import Callable, List, Optional

import torch

from mcquic_tpu_torch import parallel
from mcquic_tpu_torch.models.quantizer import ResidualBackwardQuantizer
from mcquic_tpu_torch.ops.vq import Draw, reassignCodebook


def trainableParameters(model: torch.nn.Module) -> List[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]


def globalNorm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (`optax.global_norm`)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def averageOverRanks(params: List[torch.Tensor], logged: List[torch.Tensor]):
    """The gradients of `params` (zeros where a parameter has none) and
    detached copies of the `logged` scalars, each averaged over the ranks in
    one collective per dtype (`parallel.allReduceMean_`)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    logged = [t.detach().clone() for t in logged]
    parallel.allReduceMean_(grads + logged)
    return grads, logged


def makeTrainStep(model, optimizer, distortionFn: Callable, lpipsFn: Optional[Callable] = None,
                  clipNorm: float = 4.0, distortionWeight: float = 0.5, mseWeight: float = 0.5,
                  lpipsWeight: float = 2.0):
    """(batch [n, 3, H, W] in [-1, 1], draw) -> metrics; updates `model` and
    `optimizer` in place. The optimizer's parameters are the model's
    trainable ones, in order."""
    params = optimizer.params

    def step(batch: torch.Tensor, draw: Draw) -> dict:
        frequencies = model._quantizer.frequencies()
        saved = [f.detach().clone() for f in frequencies]
        model.train()
        for p in params:
            p.grad = None
        xHat, yHat, codes, logits = model(batch, draw)
        distortion = distortionFn(xHat, batch, codes, logits)
        mse = ((xHat - batch) ** 2).mean()
        lpips = lpipsFn(xHat, batch) if lpipsFn is not None else torch.zeros_like(mse)
        loss = distortionWeight * distortion + mseWeight * mse + lpipsWeight * lpips
        loss.backward()
        grads, (loss, distortion, mse, lpips) = averageOverRanks(params,
                                                                 [loss, distortion, mse, lpips])
        gnorm = globalNorm(grads).detach()
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        with torch.no_grad():
            if ok:
                scale = torch.clamp(clipNorm / torch.clamp_min(gnorm, 1e-12), max=1.0)
                torch._foreach_mul_(grads, scale)
                optimizer.step(grads)
            else:
                for f, s in zip(frequencies, saved):
                    f.copy_(s)
        for p in params:
            p.grad = None
        return {"loss": loss, "distortion": distortion, "mse": mse, "lpips": lpips,
                "gradNorm": gnorm, "skipped": 0.0 if ok else 1.0}

    return step


def sharesCodebook(model) -> bool:
    """True for Neon, whose levels share one codebook."""
    return isinstance(model._quantizer, ResidualBackwardQuantizer)


def reassignShapes(model) -> List[tuple]:
    """The shapes of the uniforms `refreshCodebooks` takes."""
    frequencies = model._quantizer.frequencies()
    return [tuple(frequencies[0].shape)] if sharesCodebook(model) else \
        [tuple(f.shape) for f in frequencies]


@torch.no_grad()
def refreshCodebooks(model, uniforms: List[torch.Tensor]) -> torch.Tensor:
    """Dead-codeword reassignment (`state.py:93-128`). Per-level codebooks
    (v1): each level's from its normalized `freqEMA`, one [m, k] draw per
    level. The shared codebook (Neon): each level's frequencies normalized,
    averaged over the levels, and one reassignment of the one codebook, one
    [1, k] draw. A codebook is written in place (`copy_`, which moves its
    version counter). Returns the mean proportion of codewords moved."""
    quantizer = model._quantizer
    if sharesCodebook(model):
        merged = torch.stack([f / f.sum(-1, keepdim=True) for f in quantizer.frequencies()]).mean(0)
        new, prop = reassignCodebook(quantizer.codebook, merged, uniforms[0])
        quantizer.codebook.copy_(new)
        return prop
    props = []
    for i, (freq, u) in enumerate(zip(quantizer.frequencies(), uniforms)):
        codebook = quantizer.codebook(i)
        new, prop = reassignCodebook(codebook, freq / freq.sum(-1, keepdim=True), u)
        codebook.copy_(new)
        props.append(prop)
    return torch.stack(props).mean()


def codeUsage(model, eps: float = 1e-6) -> float:
    """The mean over levels of the fraction of codewords whose normalized
    frequency exceeds eps (`state.py:131`; Neon's levels all have k
    codewords, so this is the mean over its stacked [L, 1, k] table)."""
    used = [((f / f.sum(-1, keepdim=True)) > eps).float().mean()
            for f in model._quantizer.frequencies()]
    return float(torch.stack(used).mean())
