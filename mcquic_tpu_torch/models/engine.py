"""CompressorEngine: the codec object tying the model, the rANS coder and the
`.mcq` container together (counterpart of `mcquic_tpu/models/engine.py`,
reference `mcquic/modules/compressor.py:67-117`).

Device work runs under `utils.exactFp32` (fp32, TF32 off) and
`torch.inference_mode`. Host <-> device traffic is one array each way:
  * compressImage uploads the reflect-padded uint8 image and normalizes it
    on the device (`engine.py:118-124`); the codes of all levels come back
    as one packed 16-bit array (`engine.py:97`);
  * decompressImage uploads the packed codes, widens them on the device,
    decodes, and converts to uint8 on the device (`engine.py:232-234`).
"""
from typing import List, Sequence, Tuple

import numpy as np
import torch

import mcquic_tpu_torch
from mcquic_tpu_torch.coding import RansCoder
from mcquic_tpu_torch.container import File, FileHeader, ImageSize
from mcquic_tpu_torch.data.transforms import alignedPadding, centerCropTo
from mcquic_tpu_torch.models.compressor import Compressor
from mcquic_tpu_torch.utils import exactFp32, resolveDevice


ALIGN = 128          # pad to multiples of 128, as the reference does (transforms.py:81-99)


def _toU16Bits(codes: torch.Tensor) -> torch.Tensor:
    """int codes in [0, 65536) -> int16 with the same 16 bits (host views them as uint16)."""
    codes = codes.to(torch.int32)
    return torch.where(codes >= 32768, codes - 65536, codes).to(torch.int16)


class CompressorEngine:
    """Owns a v1 `Compressor` on a device; exposes encode/decode,
    compress/decompress and the image-level compressImage/decompressImage."""

    def __init__(self, model: Compressor, qp: str = "-1", device="cuda"):
        self._device = resolveDevice(device)
        self._model = model.to(self._device).eval().requires_grad_(False)
        self._qp = qp
        self._m = [model.m] * len(model.k)
        self._k = list(model.k)
        if max(self._k) > 1 << 16:
            raise ValueError("codes are carried in 16 bits; k must be <= 65536")
        self._coder = RansCoder(self._m, self._k)
        self._coder.updateFreq([f.detach().cpu().double().numpy()
                                for f in model._quantizer.frequencies()])

    @property
    def model(self) -> Compressor:
        return self._model

    @property
    def coder(self) -> RansCoder:
        return self._coder

    def encode(self, x: np.ndarray) -> List[np.ndarray]:
        """uint8 NHWC images -> codes per level [n, m, h, w] int32. The images
        are reflect-padded to multiples of ALIGN, uploaded as uint8 and
        mapped to [-1, 1] on the device."""
        x = np.asarray(x)
        if x.dtype != np.uint8 or x.ndim != 4:
            raise TypeError(f"encode takes uint8 [n, h, w, c] images, got {x.dtype} {x.shape}")
        with exactFp32(), torch.inference_mode():
            xDev = torch.tensor(alignedPadding(x, ALIGN), device=self._device)
            xDev = (xDev.float() / 255.0 - 0.5) * 2.0
            xDev = xDev.to(next(self._model.parameters()).dtype).permute(0, 3, 1, 2)
            codes = self._model.encode(xDev)
            packed = torch.cat([_toU16Bits(c.reshape(c.shape[0], -1)) for c in codes], 1)
            packedHost = packed.cpu().numpy().view(np.uint16)
        out, cur = [], 0
        for c in codes:
            size = c[0].numel()
            out.append(packedHost[:, cur:cur + size].reshape(c.shape).astype(np.int32))
            cur += size
        return out

    def decode(self, codes: Sequence[np.ndarray], toImage: bool = False) -> np.ndarray:
        """codes per level [n, m, h, w] -> restored NHWC, still padded: float
        in [-1, 1], or uint8 when toImage."""
        n = codes[0].shape[0]
        packed = np.concatenate([np.asarray(c).reshape(n, -1) for c in codes], 1)
        packed = packed.astype(np.uint16).view(np.int16)
        with exactFp32(), torch.inference_mode():
            flat = torch.from_numpy(packed).to(self._device).to(torch.int64) & 0xFFFF
            levels, cur = [], 0
            for c in codes:
                size = int(np.prod(c.shape[1:]))
                levels.append(flat[:, cur:cur + size].reshape(c.shape))
                cur += size
            y = self._model.decode(levels)
            if toImage:
                y = torch.clamp(torch.round((y * 0.5 + 0.5) * 255.0), 0, 255).to(torch.uint8)
            return y.permute(0, 2, 3, 1).cpu().numpy()

    def compress(self, x: np.ndarray) -> Tuple[List[np.ndarray], List[List[bytes]], List[FileHeader]]:
        """uint8 NHWC images -> (codes, binaries[n][level], headers[n])."""
        n, h, w, c = x.shape
        codes = self.encode(x)
        binaries, codeSizes = self._coder.compress(codes)
        headers = [FileHeader(mcquic_tpu_torch.__version__, self._qp, cs, ImageSize(h, w, c))
                   for cs in codeSizes]
        return codes, binaries, headers

    def decompress(self, binaries: List[List[bytes]], headers: List[FileHeader],
                   toImage: bool = False) -> np.ndarray:
        """Entropy-decode, decode, center-crop to the recorded size."""
        codes = self._coder.decompress(binaries, [h.CodeSize for h in headers])
        ims = headers[0].ImageSize
        return centerCropTo(self.decode(codes, toImage), ims.height, ims.width)

    def compressImage(self, img: np.ndarray) -> File:
        """uint8 HWC image -> `.mcq` File."""
        _, binaries, headers = self.compress(np.asarray(img, np.uint8)[None])
        return File(headers[0], binaries[0])

    def decompressImage(self, file: File) -> np.ndarray:
        """`.mcq` File -> uint8 HWC image."""
        return self.decompress([file.Content], [file.FileHeader], toImage=True)[0]
