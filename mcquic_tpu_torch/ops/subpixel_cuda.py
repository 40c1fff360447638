"""Wrapper of kernel K2, the thin RGB head: 3x3 conv + bias + depth-to-space
(csrc/thin_head.cu).

Replaces `mcquic_tpu/ops/subpixel_pallas.py::conv3x3SubpixelThin`. For a
tensor on the CPU the wrapper runs the plain version (`F.conv2d` +
`F.pixel_shuffle`); for a CUDA tensor it launches the kernel or raises.
`conv3x3SubpixelThin.launches` counts kernel launches.
"""
import ctypes

import torch
import torch.nn.functional as F

MAX_FEATURES = 16
TILE = (8, 32)         # input rows x columns per block (mcq_thin_head_tile)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from mcquic_tpu_torch.utils.build import loadCudaLibrary
        lib = loadCudaLibrary("thin_head")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mcq_thin_head.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        lib.mcq_thin_head.restype = i32
        lib.mcq_thin_head_tile.restype = i32
        if lib.mcq_thin_head_tile() != TILE[0] * 1000 + TILE[1]:
            raise RuntimeError("thin_head.cu and ops/subpixel_cuda.py disagree on the tile")
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library now (it is otherwise built at
    first launch)."""
    _library()


def thinHeadGrid(B: int, H: int, W: int):
    """K2's grid: one block of 4 warps per TILE of input pixels per image,
    (column tiles, row tiles, B)."""
    return -(-W // TILE[1]), -(-H // TILE[0]), B


def thinHeadSupported(xShape, wShape, rate: int) -> bool:
    """Shapes the kernel takes: x [B, C, H, W], w [F, C, 3, 3] with
    C % 4 == 0, F <= 16 and F % rate^2 == 0."""
    if len(xShape) != 4 or len(wShape) != 4 or rate < 1:
        return False
    _, C, _, _ = xShape
    Fo, wc, kh, kw = wShape
    return ((kh, kw) == (3, 3) and wc == C and C % 4 == 0
            and 0 < Fo <= MAX_FEATURES and Fo % (rate * rate) == 0)


def conv3x3SubpixelPlain(x: torch.Tensor, weight: torch.Tensor, bias, rate: int) -> torch.Tensor:
    """K2's plain version: pixel_shuffle(conv3x3(x, weight) + bias, rate)."""
    return F.pixel_shuffle(F.conv2d(x, weight, bias, padding=1), rate)


def conv3x3SubpixelThin(x: torch.Tensor, weight: torch.Tensor, bias, rate: int) -> torch.Tensor:
    """x [B, C, H, W], weight [F, C, 3, 3] (OIHW), bias [F] or None ->
    [B, F / rate^2, rate*H, rate*W]. Inference only: the kernel has no
    backward, so a call that needs a gradient raises."""
    if x.device.type == "cpu":
        return conv3x3SubpixelPlain(x, weight, bias, rate)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"conv3x3SubpixelThin: x on {x.device}, weight on {weight.device}")
    if not thinHeadSupported(x.shape, weight.shape, rate):
        raise ValueError(f"conv3x3SubpixelThin: shapes x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, rate {rate} are not taken by the kernel "
                         f"(C % 4 == 0, F <= {MAX_FEATURES}, F % rate^2 == 0)")
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError("conv3x3SubpixelThin: the CUDA kernel takes fp32 only")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError("conv3x3SubpixelThin: the kernel has no backward; call it "
                           "under torch.no_grad() or torch.inference_mode()")
    B, C, H, W = x.shape
    Fo = weight.shape[0]
    x, weight = x.contiguous(), weight.contiguous()             # OIHW, read as it is
    if bias is not None:
        bias = bias.float().contiguous()
    out = torch.empty((B, Fo // (rate * rate), rate * H, rate * W),
                      dtype=torch.float32, device=x.device)
    lib = _library()
    index = x.get_device()
    args = (x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, C, H, W, Fo, rate, torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        status = lib.mcq_thin_head(*args)
    else:
        with torch.cuda.device(index):
            status = lib.mcq_thin_head(*args)
    from mcquic_tpu_torch.utils.build import checkCuda
    checkCuda(lib, status, "thin_head kernel")
    conv3x3SubpixelThin.launches += 1
    return out


conv3x3SubpixelThin.launches = 0
