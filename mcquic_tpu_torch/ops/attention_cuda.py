"""Wrapper of kernel K3, attention with an online softmax
(csrc/flash_attention.cu).

Replaces `mcquic_tpu/ops/attention_pallas.py::flashAttention`. For a tensor
on the CPU the wrapper runs the plain version
(`ops/attention.py::flashAttentionPlain`); for a CUDA tensor it launches the
kernel or raises. The kernel reads q, k and v in the generator's
[B, T, H, D] layout through their strides (D must be contiguous), so a
prefix slice of a KV cache goes in without a copy. `flashAttention.launches`
counts kernel launches.
"""
import ctypes
import math

import torch

from mcquic_tpu_torch.ops.attention import flashAttentionPlain

MAX_D = 128
_lib = None


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.utils.build import loadCudaLibrary
        lib = loadCudaLibrary("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mcq_flash_attention.argtypes = ([ptr, ptr, ptr, ptr, i64, ptr] + [i32] * 5
                                            + [ctypes.c_float] + [i64] * 12 + [ptr])
        lib.mcq_flash_attention.restype = i32
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library now (it is otherwise built at
    first launch)."""
    _library()


def flashAttention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor = None, scale: float = None) -> torch.Tensor:
    """q [B, Tq, H, D], k/v [B, Tk, H, D] (fp32 on CUDA), mask [Tq, Tk]
    (nonzero = attend) or None -> [B, Tq, H, D]. Inference only: the kernel
    has no backward, so a call that needs a gradient raises, on the CPU too."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flashAttention: the kernel has no backward; call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if q.device.type == "cpu":
        return flashAttentionPlain(q, k, v, mask, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
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
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flashAttention: the head dim of q, k and v must be contiguous")
    if mask is not None:
        if mask.shape != (Tq, Tk) or mask.device != q.device:
            raise ValueError(f"flashAttention: mask {tuple(mask.shape)} on {mask.device} is "
                             f"not [{Tq}, {Tk}] on {q.device}")
        if mask.dtype != torch.int8:
            mask = (mask != 0).to(torch.int8)
        if mask.stride(1) != 1:
            mask = mask.contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, Tq, H, D), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mcq_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), 0 if mask is None else mask.stride(0),
            out.data_ptr(), B, H, Tq, Tk, D, float(scale),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
            stream)
    from mcquic_tpu_torch.utils.build import checkCuda
    checkCuda(lib, status, "flash_attention kernel")
    flashAttention.launches += 1
    return out


flashAttention.launches = 0
