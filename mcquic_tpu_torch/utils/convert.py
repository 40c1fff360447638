"""Weights of the JAX package -> the port's state dict, and the zoo loader.

The port's modules carry the reference McQuic (PyTorch) names, so this is
the inverse of `mcquic_tpu/utils/convert.py::buildCompressorMap`, which maps
those names onto the flax tree. Transforms:
  * conv kernels HWIO -> OIHW;
  * GDN gamma [1, in, out] -> [out, in] (beta and gamma stay in reparam space);
  * temperature [m] -> [m, 1, 1, 1]; codebooks [m, k, d] as they are;
  * `coder/_quantizer/freqEMA{L}` -> `_quantizer._entropyCoder._freqEMA.{L}`.

Zoo files (`train/saver.py` format) are npz archives of the flattened flax
tree, '/'-joined, where bf16 leaves are stored as their uint16 bits under
`key@bf16`, with a json sidecar holding `{config, version, qp}`.
"""
import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from mcquic_tpu_torch.utils import hashOfFile

HASH_FILE = Path(__file__).resolve().parent.parent / "models_hash.json"
BF16_SUFFIX = "@bf16"


def _conv(w):
    return np.transpose(w, (3, 2, 0, 1))        # HWIO -> OIHW


def _gamma(g):
    return np.transpose(g[0], (1, 0))           # [1, in, out] -> [out, in]


def _temperature(t):
    return np.asarray(t).reshape(-1, 1, 1, 1)


def _same(a):
    return a


class _Map:
    """torch key -> (flax key, transform), built in the port's module order."""

    def __init__(self):
        self.entries: Dict[str, Tuple[str, callable]] = {}

    def add(self, torchKey: str, flaxPath: Tuple[str, ...], fn=_same):
        assert torchKey not in self.entries, torchKey
        self.entries[torchKey] = ("/".join(flaxPath), fn)

    def conv(self, torchPrefix: str, flaxPrefix: Tuple[str, ...]):
        # the JAX package's conv modules wrap an inner nn.Conv named Conv_0
        self.add(f"{torchPrefix}.weight", (*flaxPrefix, "Conv_0", "kernel"), _conv)
        self.add(f"{torchPrefix}.bias", (*flaxPrefix, "Conv_0", "bias"))

    def gdn(self, torchPrefix: str, flaxPrefix: Tuple[str, ...]):
        self.add(f"{torchPrefix}.beta", (*flaxPrefix, "beta"))
        self.add(f"{torchPrefix}.gamma", (*flaxPrefix, "gamma"), _gamma)

    def residualBlock(self, t: str, f: Tuple[str, ...]):
        self.conv(f"{t}._branch.1", (*f, "Conv_0"))
        self.conv(f"{t}._branch.3", (*f, "Conv_1"))

    def residualBlockStride(self, t: str, f: Tuple[str, ...]):
        self.conv(f"{t}._branch.1", (*f, "Conv_0"))
        self.gdn(f"{t}._branch.2", (*f, "GenDivNorm_0"))
        self.conv(f"{t}._branch.3", (*f, "Conv_1"))
        self.conv(f"{t}._skip", (*f, "Conv_2"))

    def residualBlockShuffle(self, t: str, f: Tuple[str, ...]):
        self.conv(f"{t}._branch.1.0", (*f, "PixelShuffleConv_0"))
        self.gdn(f"{t}._branch.2", (*f, "InvGenDivNorm_0"))
        self.conv(f"{t}._branch.3", (*f, "Conv_0"))
        self.conv(f"{t}._skip.0", (*f, "PixelShuffleConv_1"))

    def attentionBlock(self, t: str, f: Tuple[str, ...]):
        for j in range(3):
            self.residualBlock(f"{t}._mainBranch.{j}", (*f, f"ResidualBlock_{j}"))
        for j in range(3):
            self.residualBlock(f"{t}._sideBranch.{j}", (*f, f"ResidualBlock_{3 + j}"))
        self.conv(f"{t}._sideBranch.3", (*f, "Conv_0"))


def compressorMap(levels: int) -> _Map:
    """The v1 `Compressor`'s name map for `levels` codebook levels."""
    mp = _Map()
    e = ("params", "_encoder")
    mp.conv("_encoder.0", (*e, "Conv_0"))
    mp.residualBlock("_encoder.1", (*e, "ResidualBlock_0"))
    mp.residualBlockStride("_encoder.2", (*e, "ResidualBlockWithStride_0"))
    mp.attentionBlock("_encoder.3", (*e, "AttentionBlock_0"))
    mp.residualBlock("_encoder.4", (*e, "ResidualBlock_1"))
    mp.residualBlockStride("_encoder.5", (*e, "ResidualBlockWithStride_1"))
    mp.residualBlock("_encoder.6", (*e, "ResidualBlock_2"))
    d = ("params", "_decoder")
    mp.residualBlock("_decoder.0", (*d, "ResidualBlock_0"))
    mp.residualBlockShuffle("_decoder.1", (*d, "ResidualBlockShuffle_0"))
    mp.attentionBlock("_decoder.2", (*d, "AttentionBlock_0"))
    mp.residualBlock("_decoder.3", (*d, "ResidualBlock_1"))
    mp.residualBlockShuffle("_decoder.4", (*d, "ResidualBlockShuffle_1"))
    mp.residualBlock("_decoder.5", (*d, "ResidualBlock_2"))
    mp.conv("_decoder.6.0", (*d, "PixelShuffleConv_0"))
    q = ("params", "_quantizer")
    for lv in range(levels):
        te = f"_quantizer._encoders.{lv}"
        mp.add(f"{te}._quantizer._codebook", (*q, f"codebook{lv}"))
        mp.add(f"{te}._quantizer._temperature", (*q, f"temperature{lv}"), _temperature)
        lse = (*q, f"_latentStageEncoders_{lv}")
        mp.residualBlockStride(f"{te}._latentStageEncoder.0", (*lse, "ResidualBlockWithStride_0"))
        mp.residualBlock(f"{te}._latentStageEncoder.1", (*lse, "ResidualBlock_0"))
        mp.attentionBlock(f"{te}._latentStageEncoder.2", (*lse, "AttentionBlock_0"))
        for head, flaxName in (("_quantizationHead", "_quantizationHeads"),
                               ("_latentHead", "_latentHeads")):
            if head == "_latentHead" and lv == levels - 1:
                continue
            h = (*q, f"{flaxName}_{lv}")
            mp.residualBlock(f"{te}.{head}.0", (*h, "ResidualBlock_0"))
            mp.attentionBlock(f"{te}.{head}.1", (*h, "AttentionBlock_0"))
            mp.conv(f"{te}.{head}.2", (*h, "Conv_0"))
        td = f"_quantizer._decoders.{lv}"
        for head, flaxName in (("_dequantizationHead", "_dequantizationHeads"),
                               ("_sideHead", "_sideHeads")):
            if head == "_sideHead" and lv == levels - 1:
                continue
            h = (*q, f"{flaxName}_{lv}")
            mp.attentionBlock(f"{td}.{head}.0", (*h, "AttentionBlock_0"))
            mp.conv(f"{td}.{head}.1", (*h, "Conv_0"))
            mp.residualBlock(f"{td}.{head}.2", (*h, "ResidualBlock_0"))
        rh = (*q, f"_restoreHeads_{lv}")
        mp.attentionBlock(f"{td}._restoreHead.0", (*rh, "AttentionBlock_0"))
        mp.residualBlock(f"{td}._restoreHead.1", (*rh, "ResidualBlock_0"))
        mp.residualBlockShuffle(f"{td}._restoreHead.2", (*rh, "ResidualBlockShuffle_0"))
    for lv in range(levels):
        mp.add(f"_quantizer._entropyCoder._freqEMA.{lv}", ("coder", "_quantizer", f"freqEMA{lv}"))
    return mp


def fromJaxParams(flat: Dict[str, np.ndarray], levels: int = None) -> Dict[str, torch.Tensor]:
    """Flattened flax variables ('/'-joined keys, numpy values) -> the port's
    state dict. Missing or unused keys raise."""
    if levels is None:
        levels = sum(1 for key in flat if key.startswith("params/_quantizer/codebook"))
    mp = compressorMap(levels)
    missing = [fk for fk, _ in mp.entries.values() if fk not in flat]
    unused = sorted(set(flat) - {fk for fk, _ in mp.entries.values()})
    if missing or unused:
        raise KeyError(f"{len(missing)} parameters missing (e.g. {missing[:3]}), "
                       f"{len(unused)} not used (e.g. {unused[:3]})")
    return {tk: torch.from_numpy(np.array(fn(np.asarray(flat[fk])), copy=True))
            for tk, (fk, fn) in mp.entries.items()}


def bf16ToFloat32(u16: np.ndarray) -> np.ndarray:
    """bf16 bits (stored as uint16) -> float32: the bf16 bits are the high
    half of the float32 with the same value."""
    return (np.asarray(u16, np.uint16).astype(np.uint32) << 16).view(np.float32)


def readExport(path) -> Tuple[Dict[str, np.ndarray], dict]:
    """An exported model file -> (flat fp32 arrays, sidecar metadata)."""
    path = Path(path)
    flat = {}
    with np.load(str(path), allow_pickle=False) as z:
        for key in z.files:
            if key.endswith(BF16_SUFFIX):
                flat[key[:-len(BF16_SUFFIX)]] = bf16ToFloat32(z[key])
            else:
                flat[key] = z[key]
    metaPath = path.with_suffix(".json")
    if not metaPath.exists():
        raise RuntimeError(f"Model file {path} lacks its metadata sidecar {metaPath.name}.")
    return flat, json.loads(metaPath.read_text())


def modelsHash() -> Dict[str, str]:
    return json.loads(HASH_FILE.read_text())


def zooSlot(path) -> str:
    """`qp_2_msssim_ec233f2c.mcquic.npz` -> `qp_2_msssim`."""
    name = Path(path).name.split(".")[0]
    return name.rsplit("_", 1)[0]


def verifyZooHash(path):
    """The file's sha256 must start with the prefix registered for its slot."""
    slot = zooSlot(path)
    hashes = modelsHash()
    if slot not in hashes:
        raise RuntimeError(f"{Path(path).name}: no registered zoo slot `{slot}` "
                           f"(known: {sorted(hashes)}).")
    digest = hashes[slot].lower()
    actual = hashOfFile(path)
    if not actual.startswith(digest):
        raise RuntimeError(f"{Path(path).name} does not match the registered hash prefix "
                           f"{digest} (got {actual[:len(digest)]}).")


def modelGeometry(meta: dict) -> dict:
    """`{channel, m, k}` of a v1 Compressor from the sidecar's config."""
    model = meta["config"]["model"]
    params = dict(model["params"])
    if "size" in params or model.get("key") != "Compressor":
        raise NotImplementedError(f"Only the v1 Compressor is ported; got {model.get('key')} "
                                  f"with params {sorted(params)}.")
    m = params["m"]
    if isinstance(m, (list, tuple)):
        if len(set(m)) != 1:
            raise ValueError(f"per-level m {m} is not supported (must be uniform)")
        m = m[0]
    k = params["k"]
    return {"channel": int(params["channel"]), "m": int(m),
            "k": [int(v) for v in (k if isinstance(k, (list, tuple)) else [k])]}


def loadZoo(path, verify: bool = True) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A zoo model file -> (the port's fp32 state dict, sidecar metadata),
    after checking its sha256 prefix against `models_hash.json`."""
    if verify:
        verifyZooHash(path)
    flat, meta = readExport(path)
    return fromJaxParams(flat, len(modelGeometry(meta)["k"])), meta

