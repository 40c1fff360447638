"""Plain PyTorch statements of what the benchmark holds the program to.

Nothing here imports the program, JAX or the JAX package. Every model runs
in fp32 with TF32 off (`precision()`); `precision(tf32=True)` is the
control, the same computation one step of precision below.
"""
import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    """fp32 convolutions and matrix products, or TF32 ones for the control."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
