"""Wrapper of kernel K1, the nearest-codeword search (csrc/vq_encode.cu): an
exact argmin through a TF32 tensor-core filter.

Replaces `mcquic_tpu/ops/vq_pallas.py::vqEncodeResident`. For a tensor on
the CPU the wrapper runs the plain version (`ops/vq.py::vqEncodePlain`); for
a CUDA tensor it launches the kernel or raises. `k1Plan` chooses the launch
shape. `vqNearest.launches` counts kernel launches.

The kernel rescores its candidates against the plain version's codeword
norms (`codewordNorms`), which take several launches to sum. A codebook is
a parameter that the codec searches many times, so the norms (and their
square roots, for the filter's margin) are kept per codebook tensor and
recomputed when its version counter, storage or shape changes; a write that
bypasses the version counter (through `.data`) is not seen. A codebook
created in inference mode has no version counter, and its norms are summed
on every call. Past that, a call allocates the codes (and, where k is
split, the keys) and launches the kernel's own work only: with k split, a
key reset, the search and an unpack; otherwise the search alone.
"""
import ctypes
import functools
import weakref

import torch

from mcquic_tpu_torch.ops.plan import splitsFor
from mcquic_tpu_torch.ops.vq import vqEncodePlain
from mcquic_tpu_torch.ops.vq_grouped_cuda import codewordNorms

MAX_D = 256        # the largest d whose token and codeword tiles fit shared memory
TILE_CODEWORDS = 64
WIDE_D = 176       # d rounded up to 8 past which a block holds 64 tokens, not 128
_lib = None
_norms = {}


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.utils.build import loadCudaLibrary
        lib = loadCudaLibrary("vq_encode")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mcq_vq_nearest.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.mcq_vq_nearest.restype = i32
        lib.mcq_vq_tile_codewords.restype = i32
        lib.mcq_vq_wide_d.restype = i32
        if (lib.mcq_vq_tile_codewords(), lib.mcq_vq_wide_d()) != (TILE_CODEWORDS, WIDE_D):
            raise RuntimeError("vq_encode.cu and ops/vq_cuda.py disagree on the tiles")
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


@functools.lru_cache(maxsize=None)
def k1Plan(m: int, T: int, k: int, d: int, sms: int):
    """(tokens per block, splits, codeword tiles per split) for one call.

    A block holds 128 tokens, or 64 where d rounded up to 8 passes WIDE_D
    and the larger token tile would not fit shared memory beside the
    codeword ring; the splits are `splitPlan`'s."""
    blockTokens = 128 if -(-d // 8) * 8 <= WIDE_D else 64
    splits, perSplit = splitPlan(m, T, k, blockTokens, TILE_CODEWORDS, sms)
    return blockTokens, splits, perSplit // TILE_CODEWORDS


def filterMargin(d: int):
    """(kappa, eta) of K1's filter margin, delta_j = kappa |x| |c_j| + eta c2_j,
    as csrc/vq_encode.cu derives and computes it."""
    return 4 * (2 ** -9 + d * 2 ** -23) + 2 ** -19, 2 ** -20


@functools.lru_cache(maxsize=None)
def _smCount(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _codebookNorms(codebook: torch.Tensor):
    """(c2, sqrt(c2)) of a codebook, kept per tensor while its version,
    storage and shape stay the same."""
    if codebook.is_inference():
        c2 = codewordNorms(codebook)
        return c2, c2.sqrt()
    key = id(codebook)
    state = (codebook._version, codebook.data_ptr(), codebook.shape)
    hit = _norms.get(key)
    if hit is not None and hit[0]() is codebook and hit[1] == state:
        return hit[2], hit[3]
    c2 = codewordNorms(codebook)
    cn = c2.sqrt()
    _norms[key] = (weakref.ref(codebook, lambda _, key=key: _norms.pop(key, None)), state, c2, cn)
    return c2, cn


def vqNearest(tokens: torch.Tensor, codebook: torch.Tensor, rescored: torch.Tensor = None
              ) -> torch.Tensor:
    """tokens [m, T, d], codebook [m, k, d] (fp32) -> codes [m, T] int32.

    `rescored`, a one-element int64 CUDA tensor, receives the number of
    (token, codeword) pairs the kernel rescored in fp32 (a measurement; it
    is added to, not reset)."""
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
    if min(m, T, k) <= 0 or m * T >= 1 << 31 or k >= 1 << 31:
        raise ValueError(f"vqNearest: shapes {tuple(tokens.shape)} x "
                         f"{tuple(codebook.shape)} outside the kernel's range")
    lib = _library()
    c2, cn = _codebookNorms(codebook)
    index = tokens.get_device()
    blockTokens, splits, perSplit = k1Plan(m, T, k, d, _smCount(index))
    codes = torch.empty((m, T), dtype=torch.int32, device=tokens.device)
    keys = torch.empty((m, T), dtype=torch.int64, device=tokens.device) if splits > 1 else None
    args = (tokens.data_ptr(), codebook.data_ptr(), c2.data_ptr(), cn.data_ptr(),
            codes.data_ptr(), None if keys is None else keys.data_ptr(),
            None if rescored is None else rescored.data_ptr(),
            m, T, k, d, blockTokens, splits, perSplit,
            torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        status = lib.mcq_vq_nearest(*args)
    else:
        with torch.cuda.device(index):
            status = lib.mcq_vq_nearest(*args)
    if status:
        from mcquic_tpu_torch.utils.build import checkCuda
        checkCuda(lib, status, "vq_encode kernel")
    vqNearest.launches += 1
    return codes


vqNearest.launches = 0
