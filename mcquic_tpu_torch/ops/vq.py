"""Multi-codebook vector quantization (functional core), NCHW.

Counterpart of `mcquic_tpu/ops/vq.py` (encode side). Latents are NCHW
`[n, m*d, h, w]`; the grouped view is `[n, m, d, h, w]` (group g owns
channels `g*d:(g+1)*d`, the same split as the JAX package's
`[n, h, w, m, d]`); codes are `[n, m, h, w]`, the layout of the `.mcq`
container.

`vqEncode` routes the nearest-codeword search as
`mcquic_tpu/ops/vq_pallas.py::vqEncodeFused` does: kernel K1 (ops/vq_cuda.py)
when the codebook fits the resident budget, kernel K1b
(ops/vq_grouped_cuda.py) otherwise. Both wrappers run `vqEncodePlain` for a
CPU tensor.
"""
import torch

CHUNK = 1024
PAD_VALUE = 1e4                      # a short last chunk's padding (vq.py::vqEncodeChunked)
RESIDENT_BUDGET = 8 * 1024 * 1024    # bytes of fp32 codebook + norms (vq_pallas.py:209)


def groupLatent(x: torch.Tensor, m: int) -> torch.Tensor:
    """[n, m*d, h, w] -> [n, m, d, h, w]"""
    n, c, h, w = x.shape
    return x.reshape(n, m, c // m, h, w)


def ungroupLatent(x: torch.Tensor) -> torch.Tensor:
    """[n, m, d, h, w] -> [n, m*d, h, w]"""
    n, m, d, h, w = x.shape
    return x.reshape(n, m * d, h, w)


def vqEncodePlain(tokens: torch.Tensor, codebook: torch.Tensor,
                  chunk: int = CHUNK) -> torch.Tensor:
    """Nearest codeword per token: [m, T, d] x [m, k, d] -> [m, T] int32.

    Minimizes `||c||^2 - 2 x.c` in fp32 (x^2 is constant per token and left
    out), chunked over k so the [m, T, k] distances never exist at once.
    Ties go to the lowest index: `min` returns the first minimum inside a
    chunk, and a later chunk wins only on a strictly smaller distance.
    A short last chunk is padded to `chunk` codewords of the constant 1e4,
    as `mcquic_tpu/ops/vq.py::vqEncodeChunked` pads it, so every chunk is
    one product shape: a library GEMM of another shape may round a
    duplicate codeword's distance otherwise and split an exact tie. The
    padded distances never win; the real codewords' norms are summed
    before the padding (`codewordNorms` mirrors them).
    This is kernel K1's plain version, and what the CPU runs.
    """
    tokens = tokens.float()
    codebook = codebook.float()
    m, T, d = tokens.shape
    k = codebook.shape[1]
    best = torch.full((m, T), float("inf"), dtype=torch.float32, device=tokens.device)
    arg = torch.zeros((m, T), dtype=torch.int64, device=tokens.device)
    for k0 in range(0, k, chunk):
        cb = codebook[:, k0:k0 + chunk]
        c2 = (cb * cb).sum(-1)                                    # [m, chunk]
        pad = min(chunk, k) - cb.shape[1]
        if pad:
            padding = torch.full((m, pad, d), PAD_VALUE, dtype=torch.float32, device=cb.device)
            cb = torch.cat([cb, padding], 1)
            c2 = torch.cat([c2, (padding * padding).sum(-1)], 1)
        dist = c2[:, None, :] - 2.0 * torch.bmm(tokens, cb.transpose(1, 2))
        localMin, localArg = dist.min(-1)
        better = localMin < best
        best = torch.where(better, localMin, best)
        arg = torch.where(better, localArg + k0, arg)
    return arg.to(torch.int32)


def latentTokens(x: torch.Tensor) -> torch.Tensor:
    """Grouped latent [n, m, d, h, w] -> contiguous fp32 tokens [m, n*h*w, d]."""
    n, m, d, h, w = x.shape
    return x.permute(1, 0, 3, 4, 2).reshape(m, n * h * w, d).float().contiguous()


def residentFits(m: int, k: int, d: int) -> bool:
    """True when the fp32 codebook and its norms, k rounded up to 128, fit
    the resident kernel's budget (`vq_pallas.py::residentFits`)."""
    kp = -(-k // 128) * 128
    return m * kp * (d + 1) * 4 <= RESIDENT_BUDGET


def vqEncode(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codeword indices: x [n, m, d, h, w], codebook [m, k, d] ->
    codes [n, m, h, w] int32.

    K1 when `residentFits`, as `vqEncodeFused` chooses, and K1b otherwise.
    K1b also takes every d past K1's `MAX_D`: K1 keeps a whole d-vector tile
    of tokens and codewords in shared memory, and the card's shared memory
    per block is what caps d there."""
    from mcquic_tpu_torch.ops.vq_cuda import MAX_D, vqNearest
    from mcquic_tpu_torch.ops.vq_grouped_cuda import vqNearestGrouped
    n, m, d, h, w = x.shape
    k = codebook.shape[1]
    search = vqNearest if residentFits(m, k, d) and d <= MAX_D else vqNearestGrouped
    codes = search(latentTokens(x), codebook.float().contiguous())   # [m, T]
    return codes.reshape(m, n, h, w).permute(1, 0, 2, 3)


def vqDequantizeCodes(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Gather decode: codes [n, m, h, w], codebook [m, k, d] -> [n, m*d, h, w]."""
    m, k, d = codebook.shape
    offsets = torch.arange(m, device=codes.device).view(1, m, 1, 1) * k
    flat = codebook.reshape(m * k, d)
    gathered = flat[codes.long() + offsets]                     # [n, m, h, w, d]
    return ungroupLatent(gathered.permute(0, 1, 4, 2, 3))
