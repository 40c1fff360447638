"""Operations, bytes and peaks: the yardstick of every roofline and `mfu`.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): every
share here is taken against 495 TFLOP/s, the card's dense TF32 rate, which
is the fastest at which it multiplies fp32 inputs, so no implementation of
this fp32 work can read above 100 %; and 3.35 TB/s of HBM3.

A kernel's least time is the larger of its operations over the peak and
its bytes over the HBM rate: each input read once, each output written
once (the arithmetic of `chip_smoke.py::bound` and its kernel rows, where
K2 and K3 are charged their fp32 products once here, not the three TF32
products they take). A model's operations are counted by
`FlopCounterMode` over the plain reference on meta tensors: 2 per
multiply-add of every convolution and matrix product, whatever implements
them.
"""
from typing import Callable, Tuple

PEAK_FLOPS = 495e12            # dense TF32
PEAK_BYTES = 3.35e12           # HBM3


def bound(flops: float, nbytes: float) -> float:
    """The least seconds the card could take for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def k1(m: int, T: int, k: int, d: int) -> Tuple[float, float]:
    """K1, the nearest-codeword search of T tokens per group over k codewords
    of width d, in m groups: (operations, bytes)."""
    return 2.0 * m * T * k * d, 4.0 * (m * T * d + m * k * d + m * T)


def k2(B: int, cin: int, H: int, W: int, cout: int, r: int) -> Tuple[float, float]:
    """K2, a 3x3 convolution of [B, cin, H, W] to cout * r * r channels with
    its bias, then the depth-to-space by r: (operations, bytes)."""
    out = cout * r * r
    flops = B * (2.0 * H * W * cin * 9 * out + H * W * out)
    return flops, 4.0 * (B * cin * H * W + out * cin * 9 + out + B * out * H * W)


def k3(B: int, H: int, Tq: int, Tk: int, D: int) -> Tuple[float, float]:
    """K3, attention of Tq queries to Tk keys in B x H heads of width D
    (scores and the weighted sum): (operations, bytes)."""
    return 4.0 * B * H * Tq * Tk * D, 4.0 * B * H * D * (2 * Tq + 2 * Tk)


def modelFlops(build: Callable, run: Callable) -> float:
    """Operations of `run(model)` on meta tensors, `build()` called under the
    meta device (no memory, no time on any device)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = build()
        with FlopCounterMode(display=False) as counter:
            run(model)
    return float(counter.get_total_flops())
