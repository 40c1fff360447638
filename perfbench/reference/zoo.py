"""A published McQuic v1 model file -> the state dict of `reference.v1.Compressor`.

The file is an npz of the flax parameter tree, '/'-joined keys, bf16 leaves
stored as uint16 bits under `key@bf16`, with a json sidecar of its
geometry. Convolution kernels are HWIO (-> OIHW), GDN's gamma [1, in, out]
(-> [out, in]), the temperatures [m] (-> [m, 1, 1, 1]).
"""
import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

BF16 = "@bf16"


def readFlat(path) -> Dict[str, np.ndarray]:
    flat = {}
    with np.load(str(path), allow_pickle=False) as z:
        for key in z.files:
            if key.endswith(BF16):
                bits = z[key].astype(np.uint16).astype(np.uint32) << 16
                flat[key[:-len(BF16)]] = bits.view(np.float32)
            else:
                flat[key] = z[key]
    return flat


def geometry(path) -> dict:
    params = json.loads(Path(path).with_suffix(".json").read_text())["config"]["model"]["params"]
    return {"channel": int(params["channel"]), "m": int(params["m"]),
            "k": [int(v) for v in params["k"]]}


class _Names:
    """reference key -> (flax key, transform)."""

    def __init__(self):
        self.map = {}

    def add(self, key, path, fn=lambda a: a):
        self.map[key] = ("/".join(path), fn)

    def conv(self, t, f, bias=True):
        self.add(f"{t}.weight", (*f, "Conv_0", "kernel"), lambda w: np.transpose(w, (3, 2, 0, 1)))
        if bias:
            self.add(f"{t}.bias", (*f, "Conv_0", "bias"))

    def gdn(self, t, f):
        self.add(f"{t}.beta", (*f, "beta"))
        self.add(f"{t}.gamma", (*f, "gamma"), lambda g: np.transpose(g[0], (1, 0)))

    def res(self, t, f):
        self.conv(f"{t}._branch.1", (*f, "Conv_0"))
        self.conv(f"{t}._branch.3", (*f, "Conv_1"))

    def stride(self, t, f):
        self.conv(f"{t}._branch.1", (*f, "Conv_0"))
        self.gdn(f"{t}._branch.2", (*f, "GenDivNorm_0"))
        self.conv(f"{t}._branch.3", (*f, "Conv_1"))
        self.conv(f"{t}._skip", (*f, "Conv_2"))

    def shuffle(self, t, f):
        self.conv(f"{t}._branch.1.0", (*f, "PixelShuffleConv_0"))
        self.gdn(f"{t}._branch.2", (*f, "InvGenDivNorm_0"))
        self.conv(f"{t}._branch.3", (*f, "Conv_0"))
        self.conv(f"{t}._skip.0", (*f, "PixelShuffleConv_1"))

    def attention(self, t, f):
        for j in range(3):
            self.res(f"{t}._mainBranch.{j}", (*f, f"ResidualBlock_{j}"))
            self.res(f"{t}._sideBranch.{j}", (*f, f"ResidualBlock_{3 + j}"))
        self.conv(f"{t}._sideBranch.3", (*f, "Conv_0"))


def _v1Names(levels: int) -> _Names:
    n = _Names()
    e, d, q = ("params", "_encoder"), ("params", "_decoder"), ("params", "_quantizer")
    n.conv("_encoder.0", (*e, "Conv_0"))
    for t, kind, i in ((1, "res", 0), (2, "stride", 0), (3, "attention", 0), (4, "res", 1),
                       (5, "stride", 1), (6, "res", 2)):
        name = {"res": "ResidualBlock", "stride": "ResidualBlockWithStride",
                "attention": "AttentionBlock"}[kind]
        getattr(n, kind)(f"_encoder.{t}", (*e, f"{name}_{i}"))
    for t, kind, i in ((0, "res", 0), (1, "shuffle", 0), (2, "attention", 0), (3, "res", 1),
                       (4, "shuffle", 1), (5, "res", 2)):
        name = {"res": "ResidualBlock", "shuffle": "ResidualBlockShuffle",
                "attention": "AttentionBlock"}[kind]
        getattr(n, kind)(f"_decoder.{t}", (*d, f"{name}_{i}"))
    n.conv("_decoder.6.0", (*d, "PixelShuffleConv_0"))
    for lv in range(levels):
        te, td = f"_quantizer._encoders.{lv}", f"_quantizer._decoders.{lv}"
        n.add(f"{te}._quantizer._codebook", (*q, f"codebook{lv}"))
        n.add(f"{te}._quantizer._temperature", (*q, f"temperature{lv}"),
              lambda t: np.asarray(t).reshape(-1, 1, 1, 1))
        lse = (*q, f"_latentStageEncoders_{lv}")
        n.stride(f"{te}._latentStageEncoder.0", (*lse, "ResidualBlockWithStride_0"))
        n.res(f"{te}._latentStageEncoder.1", (*lse, "ResidualBlock_0"))
        n.attention(f"{te}._latentStageEncoder.2", (*lse, "AttentionBlock_0"))
        for head, flax in (("_quantizationHead", "_quantizationHeads"),
                           ("_latentHead", "_latentHeads")):
            if head == "_latentHead" and lv == levels - 1:
                continue
            h = (*q, f"{flax}_{lv}")
            n.res(f"{te}.{head}.0", (*h, "ResidualBlock_0"))
            n.attention(f"{te}.{head}.1", (*h, "AttentionBlock_0"))
            n.conv(f"{te}.{head}.2", (*h, "Conv_0"))
        for head, flax in (("_dequantizationHead", "_dequantizationHeads"),
                           ("_sideHead", "_sideHeads")):
            if head == "_sideHead" and lv == levels - 1:
                continue
            h = (*q, f"{flax}_{lv}")
            n.attention(f"{td}.{head}.0", (*h, "AttentionBlock_0"))
            n.conv(f"{td}.{head}.1", (*h, "Conv_0"))
            n.res(f"{td}.{head}.2", (*h, "ResidualBlock_0"))
        rh = (*q, f"_restoreHeads_{lv}")
        n.attention(f"{td}._restoreHead.0", (*rh, "AttentionBlock_0"))
        n.res(f"{td}._restoreHead.1", (*rh, "ResidualBlock_0"))
        n.shuffle(f"{td}._restoreHead.2", (*rh, "ResidualBlockShuffle_0"))
        n.add(f"_quantizer._entropyCoder._freqEMA.{lv}", ("coder", "_quantizer", f"freqEMA{lv}"))
    return n


def v1StateDict(path) -> Dict[str, torch.Tensor]:
    """The model file's weights under the reference's names, fp32 on the CPU.
    A leaf the map does not take, or a name the file lacks, raises."""
    flat = {k: v for k, v in readFlat(path).items() if k.startswith(("params/", "coder/"))}
    names = _v1Names(len(geometry(path)["k"])).map
    unused = set(flat) - {f for f, _ in names.values()}
    if unused:
        raise KeyError(f"leaves the reference does not read: {sorted(unused)[:5]}")
    return {key: torch.from_numpy(np.ascontiguousarray(fn(flat[f]), np.float32))
            for key, (f, fn) in names.items()}
