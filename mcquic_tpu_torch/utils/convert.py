"""Weights of the JAX package -> the port's state dict, and the zoo loader.

The port's codecs carry the reference McQuic (PyTorch) names, so their maps
are the inverses of `mcquic_tpu/utils/convert.py::buildCompressorMap` (v1)
and `buildNeonMap` (Neon), which map those names onto the flax tree. The
generator has no reference names to keep: its torch keys are the flax path
with dots (`transformer/block3/attention/wq` -> `transformer.blocks.3.attention.wq`).
Transforms:
  * conv kernels HWIO -> OIHW; dense kernels [in, out] -> [out, in];
    flax LayerNorm `scale` -> torch `weight`;
  * GDN gamma [1, in, out] -> [out, in] (beta and gamma stay in reparam space);
  * v1 temperature [m] -> [m, 1, 1, 1]; codebooks [m, k, d] as they are;
  * `coder/_quantizer/freqEMA{L}` -> `_quantizer._entropyCoder._freqEMA.{L}`;
  * Neon's stacked temperature [L, 1] (row 0 = smallest level) -> one
    [1, 1, 1, 1] per reference level `_quantizers.{L-1-row}`, and its stacked
    freqEMA [L, 1, k] -> `_entropyCoder._freqEMA.{row}`.

Zoo files (`train/saver.py` format) are npz archives of the flattened flax
tree, '/'-joined, where bf16 leaves are stored as their uint16 bits under
`key@bf16`, with a json sidecar holding `{config, version, qp}`. Their hash
table is `models_hash.json` beside the package, or the file
MCQUIC_MODELS_HASH_FILE names.

A reference McQuic (PyTorch) checkpoint converts into such a file
(`python -m mcquic_tpu_torch.utils.convert`, counterpart of
`mcquic_tpu/utils/convert.py:267-363`): since the port's modules carry the
reference names, the model of the geometry is built, the checkpoint's state
dict loaded into it strictly, and its state dict mapped onto the flax names.
"""
import json
import os
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

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


def _dense(w):
    return np.transpose(w, (1, 0))              # [in, out] -> [out, in]


class _Row:
    """Row i of a stacked flax leaf, as a torch value of `shape`; a flax row
    is `rowShape` (the inverse, for writing the stacked leaf back)."""

    def __init__(self, i: int, shape, rowShape):
        self.i, self.shape, self.rowShape = i, shape, rowShape

    def __call__(self, a):
        return np.asarray(a)[self.i].reshape(self.shape)


# flax leaf from a torch value, for every transform of the maps besides _Row
_INVERSE = {_conv: lambda w: np.transpose(w, (2, 3, 1, 0)), _dense: _dense,
            _gamma: lambda g: np.transpose(g, (1, 0))[None], _same: _same,
            _temperature: lambda t: np.asarray(t).reshape(-1)}


class _Map:
    """torch key -> (flax key, transform), built in the port's module order."""

    def __init__(self):
        self.entries: Dict[str, Tuple[str, callable]] = {}

    def add(self, torchKey: str, flaxPath: Tuple[str, ...], fn=_same):
        assert torchKey not in self.entries, torchKey
        self.entries[torchKey] = ("/".join(flaxPath), fn)

    def conv(self, torchPrefix: str, flaxPrefix: Tuple[str, ...], bias: bool = True):
        # the JAX package's conv modules wrap an inner nn.Conv named Conv_0
        self.add(f"{torchPrefix}.weight", (*flaxPrefix, "Conv_0", "kernel"), _conv)
        if bias:
            self.add(f"{torchPrefix}.bias", (*flaxPrefix, "Conv_0", "bias"))

    def dense(self, torchPrefix: str, flaxPrefix: Tuple[str, ...], bias: bool = True):
        self.add(f"{torchPrefix}.weight", (*flaxPrefix, "kernel"), _dense)
        if bias:
            self.add(f"{torchPrefix}.bias", (*flaxPrefix, "bias"))

    def layerNorm(self, torchPrefix: str, flaxPrefix: Tuple[str, ...]):
        self.add(f"{torchPrefix}.weight", (*flaxPrefix, "scale"))
        self.add(f"{torchPrefix}.bias", (*flaxPrefix, "bias"))

    def gdn(self, torchPrefix: str, flaxPrefix: Tuple[str, ...]):
        self.add(f"{torchPrefix}.beta", (*flaxPrefix, "beta"))
        self.add(f"{torchPrefix}.gamma", (*flaxPrefix, "gamma"), _gamma)

    def residualBlock(self, t: str, f: Tuple[str, ...], skip: bool = False,
                      denseNorm: bool = False):
        self.conv(f"{t}._branch.1", (*f, "Conv_0"))
        if denseNorm:                   # the GroupNorm in the middle SiLU's place
            self.layerNorm(f"{t}._branch.2", (*f, "GroupNorm_0"))
        self.conv(f"{t}._branch.3", (*f, "Conv_1"))
        if skip:                        # conv1x1 where the block changes width
            self.conv(f"{t}._skip", (*f, "Conv_2"))

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

    def attentionBlock(self, t: str, f: Tuple[str, ...], denseNorm: bool = False):
        for j in range(3):
            self.residualBlock(f"{t}._mainBranch.{j}", (*f, f"ResidualBlock_{j}"),
                               denseNorm=denseNorm)
        for j in range(3):
            self.residualBlock(f"{t}._sideBranch.{j}", (*f, f"ResidualBlock_{3 + j}"),
                               denseNorm=denseNorm)
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
    return _applyMap(compressorMap(levels), flat)


def neonMap(halving: Sequence[bool], t: str = "", f: Tuple[str, ...] = ("params",),
            coder: Tuple[str, ...] = ("coder",), denseNorm: bool = False) -> _Map:
    """The `Neon` tokenizer's name map (the inverse of the JAX package's
    `buildNeonMap` plus the stacked temperature and freqEMA of its
    `convertNeon`). `halving[i]` says whether construction level i (large ->
    small) halves its grid; with `denseNorm` every residual block's
    `GroupNorm_0/scale,bias` is its `_branch.2.weight,bias`. Torch keys get
    prefix `t`, flax paths `f` and `coder`."""
    mp = _Map()
    dn = denseNorm
    e = (*f, "_encoder")
    mp.conv(f"{t}_encoder.0", (*e, "Conv_0"))
    for fi, ti in enumerate([1, 9, 15]):
        mp.attentionBlock(f"{t}_encoder.{ti}", (*e, f"AttentionBlock_{fi}"), dn)
    for fi, ti in enumerate([2, 3, 5, 7, 10, 11, 12, 13, 14]):
        mp.residualBlock(f"{t}_encoder.{ti}", (*e, f"ResidualBlock_{fi}"), ti in (10, 14), dn)
    for fi, ti in enumerate([4, 6, 8]):
        mp.residualBlockStride(f"{t}_encoder.{ti}", (*e, f"ResidualBlockWithStride_{fi}"))
    d = (*f, "_decoder")
    for fi, ti in enumerate([0, 6, 15]):
        mp.attentionBlock(f"{t}_decoder.{ti}", (*d, f"AttentionBlock_{fi}"), dn)
    for fi, ti in enumerate([1, 2, 3, 4, 5, 7, 9, 11, 13, 14]):
        mp.residualBlock(f"{t}_decoder.{ti}", (*d, f"ResidualBlock_{fi}"), ti in (1, 5), dn)
    for fi, ti in enumerate([8, 10, 12]):
        mp.residualBlockShuffle(f"{t}_decoder.{ti}", (*d, f"ResidualBlockShuffle_{fi}"))
    mp.conv(f"{t}_decoder.16", (*d, "Conv_0"))

    q, tq, L = (*f, "_quantizer"), f"{t}_quantizer", len(halving)
    mp.add(f"{tq}._quantizers.0._codebook", (*q, "codebook"))
    for i in range(L):
        mp.add(f"{tq}._quantizers.{i}._temperature", (*q, "temperature"),
               _Row(L - 1 - i, (1, 1, 1, 1), (1,)))
        mp.add(f"{tq}._entropyCoder._freqEMA.{i}", (*coder, "_quantizer", "freqEMA"),
               _Row(i, (1, -1), (1, -1)))

    def upStack(torchBase, flaxBase, halves):
        mp.conv(f"{torchBase}.0", (*flaxBase, "Conv_0"), bias=False)
        if halves:
            mp.residualBlockShuffle(f"{torchBase}.1", (*flaxBase, "ResidualBlockShuffle_0"))
        else:
            mp.residualBlock(f"{torchBase}.1", (*flaxBase, "ResidualBlock_0"), denseNorm=dn)
        mp.attentionBlock(f"{torchBase}.2", (*flaxBase, "AttentionBlock_0"), dn)
        mp.residualBlock(f"{torchBase}.3", (*flaxBase, f"ResidualBlock_{0 if halves else 1}"),
                         True, dn)

    for i, halves in enumerate(halving):
        enc, te = (*q, f"_encoders_{i}"), f"{tq}._encoders.{i}"
        mp.residualBlock(f"{te}.0", (*enc, "ResidualBlock_0"), True, dn)
        mp.attentionBlock(f"{te}.1", (*enc, "AttentionBlock_0"), dn)
        if halves:
            mp.residualBlockStride(f"{te}.2", (*enc, "ResidualBlockWithStride_0"))
        else:
            mp.residualBlock(f"{te}.2", (*enc, "ResidualBlock_1"), denseNorm=dn)
        mp.conv(f"{te}.3", (*enc, "Conv_0"), bias=False)
        if i < L - 1:
            upStack(f"{tq}._backwards.{i}", (*q, f"_backwards_{i}"), halves)
        upStack(f"{tq}._decoders.{i}", (*q, f"_decoders_{i}"), halves)
    return mp


def neonMapOf(geometry: dict) -> _Map:
    """The name map of a Neon geometry (`modelGeometry`'s form)."""
    return neonMap(halvingOf(geometry["size"]), denseNorm=geometry.get("denseNorm", False))


def halvingOf(size: Sequence[int]) -> List[bool]:
    """Per construction level, whether its grid halves the previous one."""
    last, out = size[0] * 2, []
    for s in size:
        out.append(s == last // 2)
        last = s
    return out


RMS_NORMS = ("attentionNorm", "attentionNorm1", "ffnNorm", "ffnNorm1", "attentionYNorm")


def generatorMap(halving: Sequence[bool], depth: int, useAda: bool = True,
                 qkNorm: bool = True, denseNorm: bool = False,
                 textConditioned: bool = False) -> _Map:
    """`GeneratorV3SelfAttention` (and its NoAda variant): the flax tree with
    the frozen Neon under `compressor`. The generator's own scaffold decoder
    at construction level 0 (the largest) never runs and has no weights. A
    text-conditioned generator has the caption projection `capProj` in the
    class table's place."""
    mp = neonMap(halving, t="compressor.", f=("params", "compressor"),
                 coder=("coder", "compressor"), denseNorm=denseNorm)
    p = ("params",)
    if textConditioned:
        mp.dense("capProj", (*p, "capProj"))
    else:
        mp.add("classEmbed", (*p, "classEmbed"))
    for name in ("scaffoldCodebook", "firstLevelPosEmbed", "levelEmbed"):
        mp.add(name, (*p, name))
    mp.layerNorm("capToFirstNorm", (*p, "capToFirstNorm"))
    mp.dense("capToFirst", (*p, "capToFirst"))
    for i, halves in enumerate(halving):
        if i > 0:
            mp.conv(f"_decoders.{i}.0" if halves else f"_decoders.{i}", (*p, f"_decoders_{i}"))
    tr = (*p, "transformer")
    mp.layerNorm("transformer.tokenNorm", (*tr, "tokenNorm"))
    mp.dense("transformer.tokenEmbed", (*tr, "tokenEmbed"))
    mp.add("transformer.posEmbed", (*tr, "posEmbed"))
    for name in ("capNorm", "capCondNorm"):
        mp.layerNorm(f"transformer.{name}", (*tr, name))
    for name in ("capEmbed", "capCondEmbed"):
        mp.dense(f"transformer.{name}", (*tr, name))
    for b in range(depth):
        tb, fb = f"transformer.blocks.{b}", (*tr, f"block{b}")
        for name in RMS_NORMS:
            mp.add(f"{tb}.{name}.scale", (*fb, name, "scale"))
        if useAda:
            mp.dense(f"{tb}.adaLN", (*fb, "adaLN"))
        at, fa = f"{tb}.attention", (*fb, "attention")
        for name in ("wq", "wk", "wv", "wo", "wkY", "wvY"):
            mp.dense(f"{at}.{name}", (*fa, name), bias=False)
        mp.add(f"{at}.gate", (*fa, "gate"))
        if qkNorm:
            for name in ("qNorm", "kNorm", "kyNorm"):
                mp.layerNorm(f"{at}.{name}", (*fa, name))
        for name in ("w1", "w2", "w3"):
            mp.dense(f"{tb}.ffn.{name}", (*fb, "ffn", name), bias=False)
    if useAda:
        mp.dense("transformer.finalAdaLN", (*tr, "finalAdaLN"))
    mp.dense("transformer.finalLinear", (*tr, "finalLinear"))
    return mp


def varMap(halving: Sequence[bool], depth: int, attnL2Norm: bool = True,
           denseNorm: bool = False) -> _Map:
    """`GeneratorVAR` (`mcquic_tpu/models/generator_var.py`): the flax tree
    with the frozen Neon under `compressor`, the blocks as `blocks_{i}`; its
    LayerNorms have no parameters."""
    mp = neonMap(halving, t="compressor.", f=("params", "compressor"),
                 coder=("coder", "compressor"), denseNorm=denseNorm)
    p = ("params",)
    mp.dense("wordEmbed", (*p, "wordEmbed"))
    for name in ("classEmb", "posStart", "pos1LC", "lvlEmbed"):
        mp.add(name, (*p, name))
    for b in range(depth):
        tb, fb = f"blocks.{b}", (*p, f"blocks_{b}")
        mp.dense(f"{tb}.adaLN", (*fb, "adaLN"))
        mp.dense(f"{tb}.attn.qkv", (*fb, "attn", "qkv"))
        if attnL2Norm:
            mp.add(f"{tb}.attn.scaleLogit", (*fb, "attn", "scaleLogit"))
        mp.dense(f"{tb}.attn.proj", (*fb, "attn", "proj"))
        mp.dense(f"{tb}.fc1", (*fb, "fc1"))
        mp.dense(f"{tb}.fc2", (*fb, "fc2"))
    mp.dense("headAda", (*p, "headAda"))
    mp.dense("head", (*p, "head"))
    return mp


def _applyMap(mp: _Map, flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Every torch key of the map from `flat`; missing or unused keys raise."""
    missing = [fk for fk, _ in mp.entries.values() if fk not in flat]
    unused = sorted(set(flat) - {fk for fk, _ in mp.entries.values()})
    if missing or unused:
        raise KeyError(f"{len(missing)} parameters missing (e.g. {missing[:3]}), "
                       f"{len(unused)} not used (e.g. {unused[:3]})")
    return {tk: torch.from_numpy(np.array(fn(np.asarray(flat[fk])), copy=True))
            for tk, (fk, fn) in mp.entries.items()}


def generatorGeometry(flat: Dict[str, np.ndarray]) -> dict:
    """What the name map needs, read off a generator's flat params: halving
    per level and depth, then adaLN and qk-norm (`GeneratorV3SelfAttention`)
    or the l2 qk-norm (`GeneratorVAR`, `var` True); `denseNorm` and
    `textConditioned` are present only where set."""
    var = "params/pos1LC" in flat
    L = flat["params/lvlEmbed" if var else "params/levelEmbed"].shape[0]
    enc = "params/compressor/_quantizer/_encoders_{}/ResidualBlockWithStride_0/Conv_0/Conv_0/kernel"
    halving = [enc.format(i) in flat for i in range(L)]
    flags = {}
    if "params/compressor/_encoder/ResidualBlock_0/GroupNorm_0/scale" in flat:
        flags["denseNorm"] = True
    if var:
        blocks = {key.split("/")[1] for key in flat if key.startswith("params/blocks_")}
        return {"var": True, "halving": halving, "depth": len(blocks),
                "attnL2Norm": "params/blocks_0/attn/scaleLogit" in flat, **flags}
    if "params/capProj/kernel" in flat:
        flags["textConditioned"] = True
    blocks = {key.split("/")[2] for key in flat if key.startswith("params/transformer/block")}
    return {"halving": halving, "depth": len(blocks),
            "useAda": "params/transformer/finalAdaLN/kernel" in flat,
            "qkNorm": "params/transformer/block0/attention/qNorm/scale" in flat, **flags}


def generatorMapOf(geometry: dict) -> _Map:
    """The name map of a generator geometry (`generatorGeometry`)."""
    geometry = dict(geometry)
    return varMap(**geometry) if geometry.pop("var", False) else generatorMap(**geometry)


def fromJaxGeneratorParams(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A generator's flattened flax variables (`params/...`, `coder/...`) ->
    the port's `GeneratorV3SelfAttention` or `GeneratorVAR` state dict.
    Missing or unused keys raise."""
    return _applyMap(generatorMapOf(generatorGeometry(flat)), flat)


def _invertMap(mp: _Map, stateDict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's state dict -> flat flax variables, through `mp` backwards;
    the rows of a stacked flax leaf are stacked again."""
    flat, rows = {}, {}
    for tk, (fk, fn) in mp.entries.items():
        value = stateDict[tk].detach().cpu().numpy()
        if isinstance(fn, _Row):
            rows.setdefault(fk, {})[fn.i] = value.reshape(fn.rowShape)
        else:
            flat[fk] = _INVERSE[fn](value)
    for fk, byRow in rows.items():
        flat[fk] = np.stack([byRow[i] for i in range(len(byRow))])
    return flat


def toJaxGeneratorParams(stateDict: Dict[str, torch.Tensor], halving: Sequence[bool],
                         depth: int, useAda: bool = True, qkNorm: bool = True,
                         var: bool = False, attnL2Norm: bool = True, denseNorm: bool = False,
                         textConditioned: bool = False) -> Dict[str, np.ndarray]:
    """The inverse of `fromJaxGeneratorParams`: the port's generator state
    dict -> flat flax variables, for writing a checkpoint in the JAX
    package's format (`writeExport`); `var` for a `GeneratorVAR`."""
    mp = (varMap(halving, depth, attnL2Norm, denseNorm) if var
          else generatorMap(halving, depth, useAda, qkNorm, denseNorm, textConditioned))
    return _invertMap(mp, stateDict)


def toJaxParams(stateDict: Dict[str, torch.Tensor], geometry: dict) -> Dict[str, np.ndarray]:
    """The inverse of `stateDictOf`: a stage-1 model's state dict (v1
    Compressor or Neon, by `geometry`) -> flat flax variables under the JAX
    package's names (`params/...`, `coder/...`), which its `loadTree` and
    engine read."""
    if "size" in geometry:
        return _invertMap(neonMapOf(geometry), stateDict)
    return _invertMap(compressorMap(len(geometry["k"])), stateDict)


def bf16ToFloat32(u16: np.ndarray) -> np.ndarray:
    """bf16 bits (stored as uint16) -> float32: the bf16 bits are the high
    half of the float32 with the same value."""
    return (np.asarray(u16, np.uint16).astype(np.uint32) << 16).view(np.float32)


def float32ToBf16(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bits of the nearest bfloat16, ties to even (what
    `ml_dtypes` and the JAX package's `exportModel(bf16=True)` give for
    finite values)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def readExport(path, prefixes: Tuple[str, ...] = ()) -> Tuple[Dict[str, np.ndarray], dict]:
    """An exported model file -> (flat fp32 arrays, sidecar metadata). With
    `prefixes`, only the arrays whose keys start with one of them are read
    (a trainer checkpoint's `params/` and `coder/`, not its optimizer
    state)."""
    path = Path(path)
    flat = {}
    with np.load(str(path), allow_pickle=False) as z:
        for key in z.files:
            if prefixes and not key.startswith(prefixes):
                continue
            if key.endswith(BF16_SUFFIX):
                flat[key[:-len(BF16_SUFFIX)]] = bf16ToFloat32(z[key])
            else:
                flat[key] = z[key]
    metaPath = path.with_suffix(".json")
    if not metaPath.exists():
        raise RuntimeError(f"Model file {path} lacks its metadata sidecar {metaPath.name}.")
    return flat, json.loads(metaPath.read_text())


def writeExport(path, flat: Dict[str, np.ndarray], meta: dict) -> Path:
    """Flat arrays ('/'-joined keys) -> an npz and its json sidecar, the
    format `readExport` and the JAX package's `train/saver.py::loadTree`
    read."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fp:
        np.savez(fp, **flat)
    path.with_suffix(".json").write_text(json.dumps(meta))
    return path


def exportModel(path, flat: Dict[str, np.ndarray], config: dict, qp: str = "-1",
                bf16: bool = False) -> Path:
    """A deploy model in the JAX package's format (`train/saver.py::exportModel`):
    the `params/...` and `coder/...` arrays and a json sidecar
    `{config, version, qp}`, renamed `<stem>_<sha256[:8]>.mcquic.npz`. With
    `bf16`, float32 params are stored as bfloat16 bits under `key@bf16`;
    the coder's frequency tables stay exact."""
    from mcquic_tpu_torch import __version__
    out = {}
    for key, value in flat.items():
        if not key.startswith(("params/", "coder/")):
            continue
        value = np.asarray(value)
        if bf16 and key.startswith("params/") and value.dtype == np.float32:
            out[key + BF16_SUFFIX] = float32ToBf16(value)
        else:
            out[key] = value
    path = writeExport(path, out, {"config": config, "version": __version__, "qp": qp})
    final = path.with_name(f"{path.stem.split('.')[0]}_{hashOfFile(path)[:8]}.mcquic.npz")
    path.replace(final)
    path.with_suffix(".json").replace(final.with_suffix(".json"))
    return final


def modelsHash() -> Dict[str, str]:
    """The zoo's hash table (slot -> sha256 prefix): MCQUIC_MODELS_HASH_FILE,
    else the package's `models_hash.json`; empty where the file is missing."""
    path = Path(os.environ.get("MCQUIC_MODELS_HASH_FILE", HASH_FILE))
    return json.loads(path.read_text()) if path.exists() else {}


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
    """The stage-1 model's constructor arguments from the sidecar's config,
    resolved as `mcquic_tpu/train/trainer.py::resolveStage1Model` resolves
    them: a `size` pyramid means the Neon tokenizer, whatever the key says
    (`{channel, k, size}`, a list-valued k read at its first entry);
    otherwise the v1 Compressor (`{channel, m, k}`, a uniform list-valued m
    read as its int). A Neon's `denseNorm` is kept where it is set."""
    model = meta["config"]["model"]
    params = dict(model["params"])
    k = params["k"]
    if "size" in params:
        geometry = {"channel": int(params["channel"]),
                    "k": int(k[0] if isinstance(k, (list, tuple)) else k),
                    "size": [int(s) for s in params["size"]]}
        if params.get("denseNorm"):
            geometry["denseNorm"] = True
        return geometry
    m = params["m"]
    if isinstance(m, (list, tuple)):
        if len(set(m)) != 1:
            raise ValueError(f"per-level m {m} is not supported (must be uniform)")
        m = m[0]
    return {"channel": int(params["channel"]), "m": int(m),
            "k": [int(v) for v in (k if isinstance(k, (list, tuple)) else [k])]}


def stateDictOf(flat: Dict[str, np.ndarray], geometry: dict) -> Dict[str, torch.Tensor]:
    """A stage-1 model's flat flax variables -> the port's state dict, by the
    map its geometry (`modelGeometry`) names: Neon's or the v1 Compressor's."""
    if "size" in geometry:
        return _applyMap(neonMapOf(geometry), flat)
    return fromJaxParams(flat, len(geometry["k"]))


def loadZoo(path, verify: bool = True) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A zoo model file -> (the port's fp32 state dict, sidecar metadata),
    after checking its sha256 prefix against `models_hash.json`."""
    if verify:
        verifyZooHash(path)
    flat, meta = readExport(path)
    flat = {k: v for k, v in flat.items() if k.startswith(("params/", "coder/"))}
    return stateDictOf(flat, modelGeometry(meta)), meta


def stripTrainerPrefix(stateDict: dict, prefix: str = "module._compressor.") -> dict:
    """A reference trainer checkpoint's model keys without their
    `module._compressor.` prefix; other keys and the LPIPS module's are
    dropped (`mcquic_tpu/utils/convert.py:283-289`)."""
    return {key[len(prefix):]: value for key, value in stateDict.items()
            if key.startswith(prefix) and "_lpips" not in key}


def loadTorchStateDict(path) -> Dict[str, torch.Tensor]:
    """A reference torch checkpoint -> its model's state dict. Accepts a raw
    state dict, a reference trainer checkpoint (`{'trainer': {'_model':
    ...}}`, prefix stripped by `stripTrainerPrefix`) and an exported
    `{'model': ...}` (`mcquic_tpu/utils/convert.py:267-280`). The file is
    unpickled (`weights_only=False`, as the JAX package reads it): load only
    checkpoints you trust."""
    raw = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "trainer" in raw:
        stateDict = stripTrainerPrefix(raw["trainer"]["_model"])
    elif isinstance(raw, dict) and "model" in raw:
        stateDict = raw["model"]
    else:
        stateDict = raw
    return {k: torch.as_tensor(v) for k, v in stateDict.items()}


def convertReference(stateDict: Dict[str, torch.Tensor], geometry: dict) -> Dict[str, np.ndarray]:
    """A reference state dict -> the flat flax variables of the stage-1 model
    of `geometry` (`modelGeometry`'s form): the model is built and loads the
    dict strictly, each of its keys required with its shape; keys it does
    not have are left out, as the JAX converter leaves them."""
    from mcquic_tpu_torch.models.compressor import buildModel
    model = buildModel(geometry)
    wanted = model.state_dict()
    model.load_state_dict({k: v for k, v in stateDict.items() if k in wanted}, strict=True)
    return toJaxParams(model.state_dict(), geometry)


def main(argv=None):
    """Convert a reference torch checkpoint into an exported model.

    v1 geometry:   python -m mcquic_tpu_torch.utils.convert ref.ckpt out.npz \
                       --channel 128 --m 2 --k 8192,2048,512 --qp 2
    Neon geometry: ... --channel 256 --k 4096 --size 16,8,8,... (single k)
    Or read geometry from a training yaml: ... --config cfg.yaml
    """
    import argparse
    from mcquic_tpu_torch.config import Config

    parser = argparse.ArgumentParser(prog="python -m mcquic_tpu_torch.utils.convert",
                                     description=main.__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("ckpt")
    parser.add_argument("out")
    parser.add_argument("--config", type=str, default=None,
                        help="training yaml to read model geometry from")
    parser.add_argument("--channel", type=int, default=None)
    parser.add_argument("--m", type=int, default=None)
    parser.add_argument("--k", type=str, default=None, help="comma-separated")
    parser.add_argument("--size", type=str, default=None,
                        help="comma-separated Neon scale pyramid")
    parser.add_argument("--denseNorm", action="store_true")
    parser.add_argument("--qp", type=str, default="-1")
    args = parser.parse_args(argv)

    if args.config:
        params = dict(Config.load(args.config).Model.Params)
        channel, kParam = params.get("channel"), params.get("k")
        size = list(params.get("size") or []) or None
        m = params.get("m", 1)
        # legacy configs carry a uniform list m (e.g. neon.yaml m: [1]*5)
        if isinstance(m, (list, tuple)):
            if len(set(m)) != 1:
                parser.error(f"per-level m {m} is not supported (must be uniform)")
            m = m[0]
        m = int(m)
        denseNorm = bool(params.get("denseNorm", False))
    else:
        channel = args.channel
        kParam = [int(x) for x in args.k.split(",")] if args.k else None
        size = [int(x) for x in args.size.split(",")] if args.size else None
        m = args.m
        denseNorm = args.denseNorm
    # the geometry is checked before the (possibly multi-GB) checkpoint loads
    if channel is None or kParam is None:
        parser.error("provide --config or --channel/--k")
    channel = int(channel)
    if not size and m is None:
        parser.error("--m is required for v1 geometry")
    # Neon where a pyramid is given (the reference's stage-1 semantics)
    geometry = modelGeometry({"config": {"model": {"params": {
        "channel": channel, "k": kParam, "denseNorm": denseNorm,
        **({"size": size} if size else {"m": int(m)})}}}})

    flat = convertReference(loadTorchStateDict(args.ckpt), geometry)
    modelCfg = ({"key": "Neon", "params": {**geometry, "denseNorm": denseNorm}} if size
                else {"key": "Compressor", "params": geometry})
    config = Config.deserialize({"model": modelCfg}).serialize()
    final = exportModel(args.out, flat, config, qp=args.qp)
    print(final)
    return final


if __name__ == "__main__":
    main()
