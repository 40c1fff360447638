"""Wrapper of kernel K3, attention with an online softmax
(csrc/flash_attention.cu).

Replaces `mcquic_tpu/ops/attention_pallas.py::flashAttention`. For a tensor
on the CPU the wrapper runs the plain version
(`ops/attention.py::flashAttentionPlain`); for a CUDA tensor it launches the
kernel or raises. The kernel reads q, k and v in the generator's
[B, T, H, D] layout through their strides (D must be contiguous), so a
prefix slice of a KV cache goes in without a copy. `attentionPlan` chooses
the launch shape. `flashAttention.launches` counts kernel launches.

The generator calls the wrapper 72 times per generate, most of them on
levels with almost no work, so its host cost is kept low: the plan and the
card's SM count are cached, no tensor operation runs before the launch (a
mask already int8 with a contiguous row is passed as it is), and the device
is switched only when q is not on the current one.
"""
import ctypes
import functools
import math

import torch

from mcquic_tpu_torch.ops.attention import flashAttentionPlain
from mcquic_tpu_torch.ops.plan import splitsFor

MAX_D = 128
KEY_TILE = 32          # keys per tile in the kernel (mcq_flash_key_tile)
ROWS_PER_WARP = 16
WARP_CHOICES = (4, 2, 1)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.utils.build import loadCudaLibrary
        lib = loadCudaLibrary("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mcq_flash_attention.argtypes = ([ptr] * 4 + [i64] + [ptr] * 3 + [i32] * 8
                                            + [ctypes.c_float] + [i64] * 12 + [ptr])
        lib.mcq_flash_attention.restype = i32
        lib.mcq_flash_key_tile.restype = i32
        if lib.mcq_flash_key_tile() != KEY_TILE:
            raise RuntimeError("flash_attention.cu and ops/attention_cuda.py disagree on the "
                               "key tile")
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library now (it is otherwise built at
    first launch)."""
    _library()


@functools.lru_cache(maxsize=None)
def attentionPlan(B: int, H: int, Tq: int, Tk: int, sms: int):
    """(warps per block, key splits, keys per split) for one call.

    A block holds `warps` warps of 16 query rows each and walks the keys of
    one split in tiles of KEY_TILE; each split covers a whole number of
    tiles and none is empty. The plan takes the most warps per block (the
    most reuse of each K/V tile) that, with the fewest splits that reach
    it, launches at least `sms` blocks; where no choice reaches `sms`, the
    one with the most blocks. A block never holds more warps than Tq has
    16-row tiles."""
    keyTiles = -(-Tk // KEY_TILE)
    rowTiles = -(-Tq // ROWS_PER_WARP)
    best = None
    for warps in WARP_CHOICES:
        if warps > 1 and warps > rowTiles:
            continue
        base = -(-Tq // (ROWS_PER_WARP * warps)) * B * H
        splits, perSplit = splitsFor(base, keyTiles, sms)
        plan = (warps, splits, perSplit * KEY_TILE)
        blocks = base * splits
        if blocks >= sms:
            return plan
        if best is None or blocks > best[0]:
            best = (blocks, plan)
    return best[1]


@functools.lru_cache(maxsize=None)
def _smCount(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flashAttention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor = None, scale: float = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D] (fp32 on CUDA), mask [Tq, Tk]
    (nonzero = attend) or None -> [B, Tq, H, D]. Inference only: the kernel
    has no backward, so a call that needs a gradient raises, on the CPU too."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flashAttention: the kernel has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if not q.is_cuda and q.device.type == "cpu":
        return flashAttentionPlain(q, k, v, mask, scale)
    index = q.get_device()
    if not q.is_cuda or k.get_device() != index or v.get_device() != index:
        raise ValueError(f"flashAttention: q on {q.device}, k on {k.device}, v on {v.device}; "
                         "all must be on one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flashAttention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, T, H, D]")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"flashAttention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not 0 < D <= MAX_D:
        raise ValueError(f"flashAttention: head dim {D} outside the kernel's range (1..{MAX_D})")
    if q.dtype != torch.float32 or k.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("flashAttention: the CUDA kernel takes fp32 only")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("flashAttention: the head dim of q, k and v must be contiguous")
    maskPtr, maskRow = None, 0
    if mask is not None:
        if mask.shape != (Tq, Tk) or mask.get_device() != index:
            raise ValueError(f"flashAttention: mask {tuple(mask.shape)} on {mask.device} is "
                             f"not [{Tq}, {Tk}] on {q.device}")
        if mask.dtype != torch.int8:
            mask = (mask != 0).to(torch.int8)
        if mask.stride(1) != 1:
            mask = mask.contiguous()
        maskPtr, maskRow = mask.data_ptr(), mask.stride(0)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    lib = _library()
    warps, splits, perSplit = attentionPlan(B, H, Tq, Tk, _smCount(index))
    size = B * Tq * H * D
    if splits > 1:
        # out, then the splits' accumulators and (max, sum) pairs, in one allocation
        rows = B * H * Tq
        buffer = torch.empty(size + splits * rows * (D + 2), dtype=torch.float32, device=q.device)
        out = buffer.as_strided((B, Tq, H, D), (Tq * H * D, H * D, D, 1))
        outPtr = buffer.data_ptr()
        partAcc = outPtr + 4 * size
        partStat = partAcc + 4 * splits * rows * D
    else:
        out = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
        outPtr = out.data_ptr()
        partAcc = partStat = None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), maskPtr, maskRow, outPtr, partAcc,
            partStat, B, H, Tq, Tk, D, warps, splits, perSplit, scale,
            qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
            Tq * H * D, H * D, D, torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        status = lib.mcq_flash_attention(*args)
    else:
        with torch.cuda.device(index):
            status = lib.mcq_flash_attention(*args)
    if status:
        from mcquic_tpu_torch.utils.build import checkCuda
        checkCuda(lib, status, "flash_attention kernel")
    flashAttention.launches += 1
    return out


flashAttention.launches = 0
