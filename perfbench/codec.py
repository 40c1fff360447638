"""What the codec cells share: the program's engine and the reference built
from a configuration, and the comparisons that judge the engine's output.

A configuration of the v1 codec names its geometry (`channel`, `m`, `k`)
and its weights: `{"zoo": <file>, "qp": <slot>}` for a published model,
which the program loads through its zoo (`demo.loadModel`) and the
reference reads from the same file, or `{"seeded": true}` for weights made
from the seed (`weights.seeded`), handed to both.

The comparisons, each against the fp32 reference:
  * `stream_faults`: images whose streams the reference's rANS decode
    refuses (an escape, a stream that does not end where its symbols do),
    or whose header does not state the image's size and code grids;
  * `code_gap`: over every code of the sample, how much farther the code
    the program chose lies from its token than the nearest codeword does,
    squared distances in fp64 over the level's mean squared token norm;
    each level's tokens are the reference's, peeled with the program's
    codes of the levels before (teacher-forced), so a near tie that went
    the other way reads about 0, and a code chosen on other latents does not;
  * `decode_err` / `image_err`: the largest difference between the
    program's restored image and the reference's decode of the same codes,
    in [-1, 1] units for float output (`decode_err`), in levels for uint8
    less the half level that rounding alone gives (`image_err`).
"""
from typing import List, Sequence

import numpy as np
import torch

from perfbench import weights
from perfbench.harness import ROOT
from perfbench.reference import rans, v1, zoo

CANDIDATES = 8        # nearest codewords by fp32 distance, re-measured in fp64
CHUNK = 4096          # tokens per distance block


def geometry(config: dict) -> dict:
    return {"channel": config["channel"], "m": config["m"], "k": list(config["k"])}


def engine(config: dict, seed: int, device):
    """The program's codec engine for the configuration."""
    from mcquic_tpu_torch.models.engine import CompressorEngine
    source = config["weights"]
    if "zoo" in source:
        from mcquic_tpu_torch.demo import loadModel
        return loadModel(qp=source["qp"], device=device)
    from mcquic_tpu_torch.models.compressor import Compressor
    state = weights.seeded(weights.shapesOf(lambda: v1.Compressor(**geometry(config))), seed,
                           device)
    with torch.device(device):
        model = Compressor(**geometry(config))
    model.load_state_dict(state, strict=True)
    return CompressorEngine(model.eval().requires_grad_(False), device=device)


def reference(config: dict, seed: int, device) -> v1.Compressor:
    source = config["weights"]
    if "zoo" in source:
        state = zoo.v1StateDict(ROOT / source["zoo"])
    else:
        state = weights.seeded(weights.shapesOf(lambda: v1.Compressor(**geometry(config))),
                               seed, device)
    model = v1.Compressor(**geometry(config))
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def padded(images: np.ndarray, base: int = 128) -> np.ndarray:
    """Reflect-pad [n, h, w, 3] to multiples of base, centred."""
    h, w = images.shape[1:3]
    ph, pw = (-h) % base, (-w) % base
    return np.pad(images, [(0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0)],
                  mode="reflect")


def cropped(x: np.ndarray, h: int, w: int) -> np.ndarray:
    top, left = (x.shape[1] - h) // 2, (x.shape[2] - w) // 2
    return x[:, top:top + h, left:left + w]


def toInput(images: np.ndarray, device) -> torch.Tensor:
    """uint8 [n, h, w, 3] -> the padded model input [n, 3, H, W] in [-1, 1]."""
    x = torch.from_numpy(padded(images)).to(device).float()
    return ((x / 255.0 - 0.5) * 2.0).permute(0, 3, 1, 2).contiguous()


class Judge:
    """The reference model with its rANS tables, and the tallies of the
    comparisons over everything it is shown."""

    def __init__(self, ref: v1.Compressor, device):
        self.ref, self.device = ref, device
        self.cdfs = [rans.levelCdfs(f.detach().cpu().numpy()) for f in ref.frequencies()]
        self.streamFaults = 0
        self.codeGap = 0.0
        self.decodeErr = 0.0

    def codes(self, header, binaries: Sequence[bytes], h: int, w: int):
        """The codes of one image's streams [level][m, h_l, w_l], or None
        (and a fault counted) where the streams or the header are wrong."""
        ref = self.ref
        H, W = h + (-h) % 128, w + (-w) % 128
        grids = [(H // 16 >> level, W // 16 >> level) for level in range(len(ref.k))]
        size, cs = header.ImageSize, header.CodeSize
        if ((size.height, size.width, size.channel) != (h, w, 3)
                or list(cs.m) != [ref.m] * len(ref.k) or list(cs.k) != ref.k
                or list(zip(cs.heights, cs.widths)) != grids or len(binaries) != len(ref.k)):
            self.streamFaults += 1
            return None
        out = []
        for level, ((gh, gw), stream) in enumerate(zip(grids, binaries)):
            groups = np.repeat(np.arange(ref.m), gh * gw)
            try:
                symbols = rans.decode(bytes(stream), groups, self.cdfs[level])
            except ValueError:
                self.streamFaults += 1
                return None
            out.append(symbols.reshape(ref.m, gh, gw))
        return out

    def batchCodes(self, headers, binaries, h: int, w: int):
        """Codes of a batch [level] -> [n, m, h_l, w_l] tensors, or None."""
        per = [self.codes(hd, b, h, w) for hd, b in zip(headers, binaries)]
        if any(p is None for p in per):
            return None
        return [torch.from_numpy(np.stack([p[level] for p in per])).to(self.device)
                for level in range(len(per[0]))]

    def gap(self, images: np.ndarray, codes: List[torch.Tensor]):
        """Tally the code gap of a batch's codes against its images."""
        ref = self.ref
        tokens = ref.latents(toInput(images, self.device), codes)
        for level, (tok, code) in enumerate(zip(tokens, codes)):
            book = ref.codebook(level)
            m = book.shape[0]
            chosen = code.permute(1, 0, 2, 3).reshape(m, -1).long()
            scale = (tok.double() ** 2).sum(-1).mean()
            for start in range(0, tok.shape[1], CHUNK):
                t, c = tok[:, start:start + CHUNK], chosen[:, start:start + CHUNK]
                e = (book * book).sum(-1)[:, None] - 2 * torch.bmm(t, book.transpose(1, 2))
                cand = torch.cat([e.topk(CANDIDATES, -1, largest=False).indices, c[..., None]], -1)
                d = torch.stack([((t[g].double()[:, None] - book[g].double()[cand[g]]) ** 2).sum(-1)
                                 for g in range(m)])
                gap = (d[..., -1] - d.min(-1).values).max() / scale
                self.codeGap = max(self.codeGap, float(gap))

    def decode(self, codes: List[torch.Tensor], h: int, w: int) -> np.ndarray:
        """The reference's restoration of codes, float NHWC cropped to h x w."""
        y = self.ref.decode(codes).permute(0, 2, 3, 1).cpu().numpy()
        return cropped(y, h, w)
