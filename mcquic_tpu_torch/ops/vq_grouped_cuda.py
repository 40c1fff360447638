"""Wrapper of kernel K1b, the nearest-codeword search on a (token tile x
codeword tile x group) grid (csrc/vq_grouped.cu).

Replaces `mcquic_tpu/ops/vq_pallas.py::vqEncodeGrouped`: `ops/vq.py::vqEncode`
sends it every codebook that K1 cannot hold. For a tensor on the CPU the
wrapper runs the plain version (`ops/vq.py::vqEncodePlain`); for a CUDA
tensor it launches the kernel or raises. `vqNearestGrouped.launches` counts
kernel launches.
"""
import ctypes

import torch

from mcquic_tpu_torch.ops.vq import CHUNK, vqEncodePlain

_lib = None


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.utils.build import loadCudaLibrary
        lib = loadCudaLibrary("vq_grouped")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mcq_vq_grouped.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.mcq_vq_grouped.restype = i32
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library now (it is otherwise built at
    first launch)."""
    _library()


def codewordNorms(codebook: torch.Tensor) -> torch.Tensor:
    """||c||^2 per codeword [m, k], summed chunk by chunk exactly as
    `vqEncodePlain` sums it, so both see the same fp32 values."""
    return torch.cat([(cb * cb).sum(-1) for cb in codebook.split(CHUNK, 1)], 1).contiguous()


def vqNearestGrouped(tokens: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """tokens [m, T, d], codebook [m, k, d] (fp32) -> codes [m, T] int32."""
    if tokens.device.type == "cpu":
        return vqEncodePlain(tokens, codebook)
    if tokens.device.type != "cuda" or codebook.device != tokens.device:
        raise ValueError(f"vqNearestGrouped: tokens on {tokens.device}, codebook on "
                         f"{codebook.device}; both must be on one CUDA device")
    m, T, d = tokens.shape
    if codebook.dim() != 3 or codebook.shape[0] != m or codebook.shape[2] != d:
        raise ValueError(f"vqNearestGrouped: codebook {tuple(codebook.shape)} does not "
                         f"match tokens {tuple(tokens.shape)}")
    if tokens.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("vqNearestGrouped: the CUDA kernel takes fp32 only")
    if not (tokens.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("vqNearestGrouped: inputs must be contiguous")
    k = codebook.shape[1]
    if min(m, T, k, d) <= 0 or m * T >= 1 << 31 or k >= 1 << 31:
        raise ValueError(f"vqNearestGrouped: shapes {tuple(tokens.shape)} x "
                         f"{tuple(codebook.shape)} outside the kernel's range")
    lib = _library()
    c2 = codewordNorms(codebook)
    keys = torch.empty((m, T), dtype=torch.int64, device=tokens.device)
    codes = torch.empty((m, T), dtype=torch.int32, device=tokens.device)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mcq_vq_grouped(tokens.data_ptr(), codebook.data_ptr(), c2.data_ptr(),
                                    keys.data_ptr(), codes.data_ptr(), m, T, k, d, stream)
    from mcquic_tpu_torch.utils.build import checkCuda
    checkCuda(lib, status, "vq_grouped kernel")
    vqNearestGrouped.launches += 1
    return codes


vqNearestGrouped.launches = 0
