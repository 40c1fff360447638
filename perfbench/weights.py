"""Weights made from the seed, on the device, for configurations with no
published weights.

Every tensor of a state dict is cut from two draws of a `torch.Generator`
on the device (one uniform, one normal, each as long as all the
parameters together) and shaped by its name, at the scales trained models
have (these are the configuration's `assumed` weights):

    convolution and linear weights   U(-1, 1) / sqrt(fan_in)
    biases                           U(-0.1, 0.1)
    norm scales, temperatures        1 + U(-0.2, 0.2)
    GDN beta, gamma (reparam space)  1 + U(0, 0.1);  sqrt(0.1) I + U(0, 0.01)
    codebooks (the tokenizer's)      N(0, 2 / (5 d))
    embeddings, position tables,
    the generator's own codebook     N(0, 0.25)
    code frequencies                 U(0.1, 1), normalized per row
    cross-attention gates            +-U(0.3, 1)

The same seed gives the same tensors on every run of the same card type.
"""
import math
from typing import Dict, Tuple

import torch

EMBEDDINGS = ("Embed", "scaffoldCodebook")


def _shape(key: str, shape: Tuple[int, ...], u: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    name = key.rsplit(".", 1)[-1]
    if name == "_codebook":
        return z * math.sqrt(2 / (5 * shape[-1]))
    if any(word in name for word in EMBEDDINGS):
        return z * 0.5
    if "._freqEMA." in key:
        freq = 0.1 + 0.9 * u
        return freq / freq.sum(-1, keepdim=True)
    if name == "gate":
        return (0.3 + 0.7 * u) * torch.sign(z)
    if name == "beta":
        return 1 + 0.1 * u
    if name == "gamma":
        return math.sqrt(0.1) * torch.eye(shape[0], device=u.device) + 0.01 * u
    if name in ("scale", "_temperature") or (name == "weight" and len(shape) == 1):
        return 1 + 0.4 * (u - 0.5)
    if name == "weight":
        return (2 * u - 1) / math.sqrt(math.prod(shape[1:]))
    if name == "bias":
        return 0.2 * (u - 0.5)
    raise KeyError(f"no rule for {key}")


@torch.no_grad()
def seeded(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> shape  =>  name -> fp32 tensor on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=g, device=device)
    z = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        out[key] = _shape(key, tuple(shape), u[at:at + n].view(shape), z[at:at + n].view(shape))
        at += n
    return out


def shapesOf(build) -> Dict[str, Tuple[int, ...]]:
    """The state dict's shapes of the module `build()` makes, on the meta device."""
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in build().state_dict().items()}
