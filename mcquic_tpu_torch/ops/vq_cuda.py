"""Wrapper of kernel K1, the nearest-codeword search (csrc/vq_encode.cu).

Replaces `mcquic_tpu/ops/vq_pallas.py::vqEncodeResident`. For a tensor on
the CPU the wrapper runs the plain version (`ops/vq.py::vqEncodePlain`); for
a CUDA tensor it launches the kernel or raises. `vqNearest.launches` counts
kernel launches.
"""
import ctypes

import torch

from mcquic_tpu_torch.ops.plan import splitsFor
from mcquic_tpu_torch.ops.vq import vqEncodePlain

MAX_D = 256        # the kernel's shared-memory tiles hold d * 194 floats
_lib = None


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.utils.build import loadCudaLibrary
        lib = loadCudaLibrary("vq_encode")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mcq_vq_nearest.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                       i32, i32, i32, i32, i32, i32, ptr]
        lib.mcq_vq_nearest.restype = i32
        lib.mcq_vq_block_tokens.restype = i32
        lib.mcq_vq_tile_codewords.restype = i32
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library now (it is otherwise built at
    first launch)."""
    _library()


def splitPlan(m: int, T: int, k: int, blockTokens: int, tileCodewords: int,
              sms: int):
    """(splits, codewords per split) so that about two blocks per SM run.

    Each split covers a whole number of codeword tiles and none is empty."""
    splits, perSplit = splitsFor(-(-T // blockTokens) * m, -(-k // tileCodewords), 2 * sms)
    return splits, perSplit * tileCodewords


def vqNearest(tokens: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """tokens [m, T, d], codebook [m, k, d] (fp32) -> codes [m, T] int32."""
    if tokens.device.type == "cpu":
        return vqEncodePlain(tokens, codebook)
    if tokens.device.type != "cuda" or codebook.device != tokens.device:
        raise ValueError(f"vqNearest: tokens on {tokens.device}, codebook on "
                         f"{codebook.device}; both must be on one CUDA device")
    m, T, d = tokens.shape
    if codebook.dim() != 3 or codebook.shape[0] != m or codebook.shape[2] != d:
        raise ValueError(f"vqNearest: codebook {tuple(codebook.shape)} does not "
                         f"match tokens {tuple(tokens.shape)}")
    if tokens.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("vqNearest: the CUDA kernel takes fp32 only")
    if not (tokens.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("vqNearest: inputs must be contiguous")
    if not 0 < d <= MAX_D:
        raise ValueError(f"vqNearest: d {d} outside the kernel's range (1..{MAX_D})")
    k = codebook.shape[1]
    lib = _library()
    c2 = (codebook * codebook).sum(-1).contiguous()
    codes = torch.empty((m, T), dtype=torch.int32, device=tokens.device)
    sms = torch.cuda.get_device_properties(tokens.device).multi_processor_count
    splits, perSplit = splitPlan(m, T, k, lib.mcq_vq_block_tokens(),
                                 lib.mcq_vq_tile_codewords(), sms)
    if splits > 1:
        splitDist = torch.empty((splits, m, T), dtype=torch.float32, device=tokens.device)
        splitIdx = torch.empty((splits, m, T), dtype=torch.int32, device=tokens.device)
        scratch = (splitDist.data_ptr(), splitIdx.data_ptr())
    else:
        scratch = (None, None)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mcq_vq_nearest(tokens.data_ptr(), codebook.data_ptr(), c2.data_ptr(),
                                    codes.data_ptr(), scratch[0], scratch[1],
                                    m, T, k, d, splits, perSplit, stream)
    from mcquic_tpu_torch.utils.build import checkCuda
    checkCuda(lib, status, "vq_encode kernel")
    vqNearest.launches += 1
    return codes


vqNearest.launches = 0
