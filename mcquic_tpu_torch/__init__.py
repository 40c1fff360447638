"""mcquic_tpu_torch — the McQuic multi-codebook image codec in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It mirrors the layout of `mcquic_tpu/` (the JAX package, which stays the
reference) and imports only torch, numpy and the standard library.

The version string is the one the `.mcq` container records; it equals the
JAX package's so that both packages write byte-identical files.
"""

__version__ = "0.1.40"

__all__ = ["__version__"]
