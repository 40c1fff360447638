"""Validator: the real-coder evaluation loop and the speed protocol
(counterpart of `mcquic_tpu/validate/validator.py`, reference
`mcquic/validate/validator.py`).

  * `validate` (`validator.py:40-58`): every image goes through the real
    compress -> decompress path; MS-SSIM and PSNR on the uint8 images, bpp
    from the rANS streams' lengths, ideal bpp from the coder's tables.
  * `speed` (`validator.py:60-97`): `iters` calls of `compress`, then of
    `decompress`, on a seeded [10, 768, 512, 3] float batch, host clock, in
    Mpps. Each call returns host arrays, so each has finished on the card;
    rANS and both transfers are inside the time.
  * `speedModel`: the same batch through the model's `encode` and `decode`
    alone, on the device, timed to a `torch.cuda.synchronize()`: no
    transfers and no rANS, which is what the reference's own speed rows time.
"""
import time

import numpy as np
import torch

from mcquic_tpu_torch.data.transforms import imageToModelInput, modelOutputToImage
from mcquic_tpu_torch.models.engine import CompressorEngine
from mcquic_tpu_torch.utils import exactFp32
from mcquic_tpu_torch.validate.handlers import (BPPHandler, IdealBPPHandler, ImageCollector,
                                                Meters, MsSSIMHandler, PSNRHandler)


def _hsvToRgbVec(hue: np.ndarray, s: float = 0.8, v: float = 0.95) -> np.ndarray:
    """HSV -> RGB at fixed saturation and value: [...] hue -> [..., 3]."""
    h6 = (hue % 1.0) * 6.0
    sector = np.floor(h6).astype(np.int64) % 6
    f = h6 - np.floor(h6)
    p = np.full_like(f, v * (1.0 - s))
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    vv = np.full_like(f, v)
    table = np.stack([np.stack([vv, t, p], -1), np.stack([q, vv, p], -1),
                      np.stack([p, vv, t], -1), np.stack([p, q, vv], -1),
                      np.stack([t, p, vv], -1), np.stack([vv, p, q], -1)])
    return np.take_along_axis(table, sector[None, ..., None], axis=0)[0]


def visualizeCodeMaps(codes) -> list:
    """Code maps [n, m, h, w] per level -> one uint8 RGB image [n, h, w, 3]
    per (level, group); indices are hashed into hues so neighbouring codes
    get distinct colours (reference validator.py:30-38)."""
    out = []
    for code in codes:
        for g in range(code.shape[1]):
            hue = (code[:, g].astype(np.int64) * 0.61803398875) % 1.0
            out.append((_hsvToRgbVec(hue) * 255).astype(np.uint8))
    return out


class Validator:
    def __init__(self, engine: CompressorEngine, collectImages: int = 16):
        self._engine = engine
        self._meters = Meters({"msssim": MsSSIMHandler(engine.device),
                               "psnr": PSNRHandler(engine.device),
                               "bpp": BPPHandler(), "idealBpp": IdealBPPHandler()})
        self._collector = ImageCollector(maxItems=collectImages)
        self.collected: dict = {"pairs": [], "codes": None}

    def validate(self, valLoader) -> dict:
        """valLoader: a callable yielding (uint8 [1, h, w, 3], stem)."""
        self._meters.reset()
        self._collector.reset()
        total, codes = 0, None
        for batch, _ in valLoader():
            codes, binaries, headers = self._engine.compress(imageToModelInput(batch))
            restored = modelOutputToImage(self._engine.decompress(binaries, headers))
            kwargs = dict(images=batch, restored=restored, binaries=binaries[0],
                          pixels=headers[0].ImageSize.Pixels, codes=codes,
                          normalizedFreqs=self._engine.coder.NormalizedFreq,
                          batch=codes[0].shape[0])
            self._meters(**kwargs)
            self._collector(**kwargs)
            total += 1
        self.collected = {"pairs": self._collector.result(), "codes": codes}
        return {"images": total, **self._meters.results()}

    @staticmethod
    def speedBatch(batch: int, h: int, w: int) -> np.ndarray:
        """The speed protocol's input: a seeded float [batch, h, w, 3] in [-1, 1]."""
        return np.random.default_rng(0).uniform(-1, 1, (batch, h, w, 3)).astype(np.float32)

    def speed(self, iters: int = 50, batch: int = 10, h: int = 768, w: int = 512):
        """(encodeMpps, decodeMpps) under the reference protocol."""
        x = self.speedBatch(batch, h, w)
        _, binaries, headers = self._engine.compress(x)               # warm-up
        self._engine.decompress(binaries, headers)

        start = time.perf_counter()
        for _ in range(iters):
            _, binaries, headers = self._engine.compress(x)
        encodeS = time.perf_counter() - start
        start = time.perf_counter()
        for _ in range(iters):
            self._engine.decompress(binaries, headers)
        decodeS = time.perf_counter() - start
        pixels = iters * batch * h * w
        return pixels / encodeS / 1e6, pixels / decodeS / 1e6

    def speedModel(self, iters: int = 50, batch: int = 10, h: int = 768, w: int = 512):
        """(encodeMpps, decodeMpps) of the model alone on its device; h and
        w must be multiples of the model's alignment."""
        model, device = self._engine.model, self._engine.device
        dtype = next(model.parameters()).dtype

        def finish():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        with exactFp32(), torch.inference_mode():
            x = torch.from_numpy(self.speedBatch(batch, h, w)).to(device, dtype).permute(0, 3, 1, 2)
            model.decode(model.encode(x))                                # warm-up
            finish()
            start = time.perf_counter()
            for _ in range(iters):
                codes = model.encode(x)
            finish()
            encodeS = time.perf_counter() - start
            start = time.perf_counter()
            for _ in range(iters):
                model.decode(codes)
            finish()
            decodeS = time.perf_counter() - start
        pixels = iters * batch * h * w
        return pixels / encodeS / 1e6, pixels / decodeS / 1e6
