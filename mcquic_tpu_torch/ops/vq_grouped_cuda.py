"""Wrapper of kernel K1b, the nearest-codeword search for codebooks past K1's
budget (csrc/vq_grouped.cu): a block walks a k-split of codeword tiles with
its token tile fixed.

Replaces `mcquic_tpu/ops/vq_pallas.py::vqEncodeGrouped`: `ops/vq.py::vqEncode`
sends it every codebook that K1 cannot hold. For a tensor on the CPU the
wrapper runs the plain version (`ops/vq.py::vqEncodePlain`); for a CUDA
tensor it launches the kernel or raises. `groupedSplitPlan` chooses the
launch shape. `vqNearestGrouped.launches` counts kernel launches.
"""
import ctypes
import functools

import torch

from mcquic_tpu_torch.ops.plan import splitsFor
from mcquic_tpu_torch.ops.vq import CHUNK, vqEncodePlain

TILE_CODEWORDS = 64          # codewords per tile in the kernel (mcq_vq_grouped_tile_codewords)
BLOCK_TOKENS = (128, 64)     # the kernel's two token tiles
_lib = None


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.utils.build import loadCudaLibrary
        lib = loadCudaLibrary("vq_grouped")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mcq_vq_grouped.argtypes = [ptr, ptr, ptr, ptr, ptr] + [i32] * 7 + [ptr]
        lib.mcq_vq_grouped.restype = i32
        lib.mcq_vq_grouped_tile_codewords.restype = i32
        if lib.mcq_vq_grouped_tile_codewords() != TILE_CODEWORDS:
            raise RuntimeError("vq_grouped.cu and ops/vq_grouped_cuda.py disagree on the "
                               "codeword tile")
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library now (it is otherwise built at
    first launch)."""
    _library()


@functools.lru_cache(maxsize=None)
def groupedSplitPlan(m: int, T: int, k: int, sms: int):
    """(tokens per block, splits, codeword tiles per split) for one call.

    A block owns a token tile of one group and walks one split of
    TILE_CODEWORDS-codeword tiles; each split covers a whole number of tiles
    and none is empty. For each token tile, largest first, the splits are
    the fewest that give about two blocks per SM; the first tile whose grid
    fills one wave of `sms` blocks is taken, else the one with the most
    blocks."""
    tiles = -(-k // TILE_CODEWORDS)
    best = None
    for blockTokens in BLOCK_TOKENS:
        base = -(-T // blockTokens) * m
        splits, perSplit = splitsFor(base, tiles, 2 * sms)
        plan = (blockTokens, splits, perSplit)
        if base * splits >= sms:
            return plan
        if best is None or base * splits > best[0]:
            best = (base * splits, plan)
    return best[1]


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
    sms = torch.cuda.get_device_properties(tokens.device).multi_processor_count
    blockTokens, splits, perSplit = groupedSplitPlan(m, T, k, sms)
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mcq_vq_grouped(tokens.data_ptr(), codebook.data_ptr(), c2.data_ptr(),
                                    keys.data_ptr(), codes.data_ptr(), m, T, k, d,
                                    blockTokens, splits, perSplit, stream)
    from mcquic_tpu_torch.utils.build import checkCuda
    checkCuda(lib, status, "vq_grouped kernel")
    vqNearestGrouped.launches += 1
    return codes


vqNearestGrouped.launches = 0
