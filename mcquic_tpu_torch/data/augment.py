"""The training batch's augmentation, on the device (counterpart of
`mcquic_tpu/data/augment.py::trainingTransform`, reference
`mcquic/data/transforms.py:14-43`): a uint8 NHWC batch becomes float NCHW in
[-1, 1] after a random gamma (one of sRGB->linear, linear->sRGB, x^gamma
and the identity, one pick per batch), a Planckian white-balance jitter
(one illuminant per image) and independent horizontal and vertical flips;
the generator's transform (`gen=True`) leaves the flips out.

Every random value is an argument (`AugmentDraws`): the trainer draws them
from a `torch.Generator` (`augmentDraws`), the tests from the JAX package's
keys. The Planckian table is the port's own copy of the published
blackbody-locus coefficients (Kornia, Apache-2.0) that
`mcquic_tpu/data/augment.py:14-31` carries.
"""
from typing import NamedTuple

import numpy as np
import torch

from mcquic_tpu_torch import parallel

PLANCKIAN_COEFFS = np.array([
    [0.6743, 0.4029, 0.0013], [0.6281, 0.4241, 0.1665], [0.5919, 0.4372, 0.2513],
    [0.5623, 0.4457, 0.3154], [0.5376, 0.4515, 0.3672], [0.5163, 0.4555, 0.4103],
    [0.4979, 0.4584, 0.4468], [0.4816, 0.4604, 0.4782], [0.4672, 0.4619, 0.5053],
    [0.4542, 0.4630, 0.5289], [0.4426, 0.4638, 0.5497], [0.4320, 0.4644, 0.5681],
    [0.4223, 0.4648, 0.5844], [0.4135, 0.4651, 0.5990], [0.4054, 0.4653, 0.6121],
    [0.3980, 0.4654, 0.6239], [0.3911, 0.4655, 0.6346], [0.3847, 0.4656, 0.6444],
    [0.3787, 0.4656, 0.6532], [0.3732, 0.4656, 0.6613], [0.3680, 0.4655, 0.6688],
    [0.3632, 0.4655, 0.6756], [0.3586, 0.4655, 0.6820], [0.3544, 0.4654, 0.6878],
    [0.3503, 0.4653, 0.6933], [0.5829, 0.4421, 0.2288], [0.5510, 0.4514, 0.2948],
    [0.5246, 0.4576, 0.3488], [0.5021, 0.4618, 0.3941], [0.4826, 0.4646, 0.4325],
    [0.4654, 0.4667, 0.4654], [0.4502, 0.4681, 0.4938], [0.4364, 0.4692, 0.5186],
    [0.4240, 0.4700, 0.5403], [0.4127, 0.4705, 0.5594], [0.4023, 0.4709, 0.5763],
    [0.3928, 0.4713, 0.5914], [0.3839, 0.4715, 0.6049], [0.3757, 0.4716, 0.6171],
    [0.3681, 0.4717, 0.6281], [0.3609, 0.4718, 0.6380], [0.3543, 0.4719, 0.6472],
    [0.3480, 0.4719, 0.6555], [0.3421, 0.4719, 0.6631], [0.3365, 0.4719, 0.6702],
    [0.3313, 0.4719, 0.6766], [0.3263, 0.4719, 0.6826], [0.3217, 0.4719, 0.6882],
], dtype=np.float32)

# (r/g, b/g) per illuminant, in fp32 as the JAX package divides them
PLANCKIAN_RATIO = np.stack([PLANCKIAN_COEFFS[:, 0] / PLANCKIAN_COEFFS[:, 1],
                            PLANCKIAN_COEFFS[:, 2] / PLANCKIAN_COEFFS[:, 1]], 1)


class AugmentDraws(NamedTuple):
    """The random values of one batch's augmentation."""
    gammaChoice: int            # 0 sRGB->linear, 1 linear->sRGB, 2 x^gamma, 3 identity
    gamma: float                # uniform in [0, 1), mapped to [0.05, 2.0)
    jitterApply: torch.Tensor   # [n] uniforms; jitter where < p
    illuminant: torch.Tensor    # [n] int64 rows of PLANCKIAN_RATIO
    flipH: torch.Tensor         # [n] uniforms; flip where < 0.5
    flipV: torch.Tensor         # [n] uniforms


def augmentDraws(generator: torch.Generator, n: int) -> AugmentDraws:
    """One batch's random values, drawn from `generator` on its device.
    Under data parallelism the two batch-wide scalars are drawn whole on
    every rank and each per-image value at the global batch, of which the
    rank keeps its own rows (`parallel.shardedRows`)."""
    device = generator.device
    scalars = torch.rand(2, generator=generator, device=device).tolist()
    rows = parallel.shardedRows(lambda shape: torch.rand(shape, generator=generator,
                                                         device=device))
    illuminants = parallel.shardedRows(lambda shape: torch.randint(
        0, len(PLANCKIAN_RATIO), shape, generator=generator, device=device))
    return AugmentDraws(min(int(scalars[0] * 4), 3), scalars[1], rows((n,)), illuminants((n,)),
                        rows((n,)), rows((n,)))


def srgbToLinear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.0031308, 12.92 * x, 1.055 * torch.pow(x.abs(), 1 / 2.4) - 0.055)


def linearToSrgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.04045, x / 12.92, torch.pow((x + 0.055).abs() / 1.055, 2.4))


def randomGamma(x: torch.Tensor, choice: int, gamma: float) -> torch.Tensor:
    """`augment.py:86-100` for the branch `choice` and the uniform `gamma`."""
    if choice == 0:
        return srgbToLinear(x)
    if choice == 1:
        return linearToSrgb(x)
    if choice == 2:
        g = torch.tensor(gamma, dtype=torch.float32) * 1.95 + 0.05
        return torch.clamp(torch.pow(torch.clamp_min(x, 0.0), g.item()), 0.0, 1.0)
    return x


def planckianJitter(x: torch.Tensor, apply: torch.Tensor, illuminant: torch.Tensor,
                    p: float = 1.0) -> torch.Tensor:
    """x [n, 3, h, w] in [0, 1]: red and blue scaled by the illuminant's
    ratios to green where `apply` < p, then clipped to [0, 1]."""
    ratio = torch.from_numpy(PLANCKIAN_RATIO).to(x.device)[illuminant]      # [n, 2]
    on = (apply < p)[:, None]
    scale = torch.where(on, ratio, torch.ones_like(ratio)).to(x.dtype)
    ones = torch.ones_like(scale[:, :1])
    return torch.clamp(x * torch.cat([scale[:, :1], ones, scale[:, 1:]], 1)[..., None, None],
                       0.0, 1.0)


def randomFlips(x: torch.Tensor, flipH: torch.Tensor, flipV: torch.Tensor) -> torch.Tensor:
    """x [n, c, h, w]: mirrored along w where flipH < 0.5, along h where flipV < 0.5."""
    x = torch.where((flipH < 0.5)[:, None, None, None], x.flip(3), x)
    return torch.where((flipV < 0.5)[:, None, None, None], x.flip(2), x)


def trainingTransform(batch: torch.Tensor, draws: AugmentDraws, gen: bool = False) -> torch.Tensor:
    """uint8 [n, h, w, 3] -> augmented float32 [n, 3, h, w] in [-1, 1]
    (`augment.py:92-100`). `gen` is the generator's transform: the gamma and
    the jitter, no flips (the flip draws are not read)."""
    x = batch.permute(0, 3, 1, 2).float() / 255.0
    x = randomGamma(x, draws.gammaChoice, draws.gamma)
    x = planckianJitter(x, draws.jitterApply, draws.illuminant)
    if not gen:
        x = randomFlips(x, draws.flipH, draws.flipV)
    return (x - 0.5) / 0.5
