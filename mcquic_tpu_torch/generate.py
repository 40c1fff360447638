"""Stage-2 sampling: load a generator checkpoint, sample images for the given
ImageNet classes, write PNGs (counterpart of `mcquic_tpu/generate.py`,
reference `test_infer.py:13-44`).

The checkpoint is the JAX package's format (`train/saver.py`): an npz of the
flattened flax tree (`params/...`, `coder/...`; bf16 leaves as uint16 under
`key@bf16`, upcast to fp32 here) with a json sidecar whose
`meta["config"]["model"]` is `{"key", "params"}`. Keys other than params and
coder (a trainer's step, optimizer state, rng) are not read.

Sampling draws from an explicit `torch.Generator` seeded with `seed`, so one
seed gives the same images on one device; the JAX package draws other
samples from the same seed. Greedy decoding (`model.generate` with no
generator) is the same function in both packages. A `GeneratorVAR`
checkpoint samples with classifier-free guidance `cfg` and `topK`, the
others with `temperature` and `topK`, as `mcquic_tpu/generate.py:43-49`
routes them. A text-conditioned checkpoint samples from caption embeddings
[n, capDim] handed to `sample` from Python; the CLI's class ids are refused
for it (`conditionOf`).
"""
import logging
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from mcquic_tpu_torch.data.png import writePng
from mcquic_tpu_torch.data.transforms import modelOutputToImage
import mcquic_tpu_torch
import mcquic_tpu_torch.models.generator  # noqa: F401  (registers its generators)
from mcquic_tpu_torch.models.generator_var import GeneratorVAR
from mcquic_tpu_torch.utils import exactFp32, resolveDevice
from mcquic_tpu_torch.utils.convert import (fromJaxGeneratorParams, halvingOf, readExport,
                                            toJaxGeneratorParams, writeExport)
from mcquic_tpu_torch.utils.registry import GeneratorRegistry

logger = logging.getLogger("mcquic_tpu_torch.generate")

# config params the port's generators take; `loadFrom` (the trainer's
# tokenizer source) changes nothing here and is dropped.
TAKEN = ("channel", "k", "size", "qk_norm", "norm_eps", "hiddenSize", "depth", "nHeads",
         "numClasses", "useAda", "remat", "denseNorm", "textConditioned", "capDim")
DROPPED = ("loadFrom",)
# `GeneratorVAR`'s fields; like the JAX package's `constructGenerator`, its
# loader drops any other config param (a shared schema's qk_norm, say)
VAR_TAKEN = ("channel", "k", "size", "depth", "embedDim", "nHeads", "numClasses", "condDropRate",
             "normEps", "attnL2Norm", "denseNorm")

# The generator the repo last trained, configs/rd5/gen_stage2_neonA.yaml, over
# the tokenizer of configs/rd5/neon_v2_60k.yaml: 426 tokens over 9 levels,
# a 256x256 image.
GEN_STAGE2_NEON_A = dict(channel=256, k=1024, size=[16, 8, 8, 4, 4, 2, 2, 1, 1], hiddenSize=512,
                         depth=8, nHeads=8, numClasses=1000)


def generatorConfig(meta: dict):
    """(registry key, constructor kwargs) from a checkpoint's sidecar."""
    if meta is None or "config" not in meta:
        raise RuntimeError("the checkpoint's sidecar lacks its config")
    model = meta["config"]["model"]
    key, params = model["key"], dict(model.get("params") or {})
    if key not in GeneratorRegistry:
        raise NotImplementedError(f"generator `{key}` is not ported to mcquic_tpu_torch "
                                  f"(ported: {sorted(GeneratorRegistry)})")
    if key == "GeneratorVAR":
        dropped = sorted(set(params) - set(VAR_TAKEN) - set(DROPPED))
        if dropped:
            logger.info("ignoring config params not taken by GeneratorVAR: %s", dropped)
        return key, {name: params[name] for name in VAR_TAKEN if name in params}
    unknown = sorted(set(params) - set(TAKEN) - set(DROPPED))
    if unknown:
        raise ValueError(f"{key}: config params {unknown} are not taken")
    return key, {name: params[name] for name in TAKEN if name in params}


def loadGenerator(path, device="cuda") -> torch.nn.Module:
    """A generator checkpoint -> the port's generator on `device`, fp32, eval."""
    device = resolveDevice(device)
    flat, meta = readExport(Path(path), ("params/", "coder/"))
    key, kwargs = generatorConfig(meta)
    with torch.device(device):                  # the default init runs on the card
        model = GeneratorRegistry.get(key)(**kwargs)
    model.load_state_dict(fromJaxGeneratorParams(flat), strict=True)
    return model.to(device).eval().requires_grad_(False)


def conditionOf(model, condition, device) -> torch.Tensor:
    """The model's condition on `device`: class ids [n] as int64, or, for a
    text-conditioned generator, caption embeddings [n, capDim] as fp32.
    Class ids for a text-conditioned model are refused: its `capProj` takes
    embeddings, and the JAX package's model raises flax's
    ScopeParamShapeError on ids; neither package's `generate` encodes
    captions (the CLIP encoder is not in the repo)."""
    if getattr(model, "textConditioned", False):
        array = np.asarray(condition)
        if array.ndim != 2 or array.shape[1] != model.capDim or array.dtype.kind != "f":
            raise ValueError(f"this generator is text-conditioned: its condition is a float "
                             f"caption embedding [n, {model.capDim}], not class ids "
                             f"{array.shape if array.ndim != 1 else list(array)}; the JAX "
                             "package's model cannot take class ids either "
                             "(ScopeParamShapeError), and no caption encoder is in the repo")
        return torch.from_numpy(array.astype(np.float32)).to(device)
    classIds = [int(c) for c in condition]
    bad = [c for c in classIds if c > model.numClasses]
    if bad:
        raise ValueError(f"class ids {bad} are past the model's {model.numClasses} classes "
                         "(-1 or numClasses picks the null class)")
    return torch.tensor(classIds, dtype=torch.int64, device=device)


def sample(model, condition, seed: int = 0, temperature: float = 1.0,
           topK: int = 0, cfg: float = 1.5):
    """Class ids, or caption embeddings [n, capDim] for a text-conditioned
    generator (`conditionOf`) -> (codes small -> large, uint8 NHWC images)
    on the model's device, fp32 with TF32 off, drawn with a
    `torch.Generator` seeded with `seed`: `GeneratorVAR` with guidance
    `cfg`, the others at `temperature`."""
    device = next(model.parameters()).device
    condition = conditionOf(model, condition, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    with exactFp32(), torch.inference_mode():
        if isinstance(model, GeneratorVAR):
            codes, restored = model.generate(condition, generator, cfg=cfg, topK=topK)
        else:
            codes, restored = model.generate(condition, generator, temperature, topK)
        images = modelOutputToImage(restored.permute(0, 2, 3, 1).cpu().numpy())
    return codes, images


def main(modelPath, classIds: Sequence[int], outputDir, topK: int = 0,
         temperature: float = 1.0, seed: int = 0, device="cuda", cfg: float = 1.5) -> List[Path]:
    """Sample one image per class id into `outputDir/class{id}_{i}.png`."""
    model = loadGenerator(modelPath, device)
    conditionOf(model, classIds, "cpu")          # refuses ids for a text-conditioned model
    outputDir = Path(outputDir)
    outputDir.mkdir(parents=True, exist_ok=True)
    _, images = sample(model, classIds, seed, temperature, topK, cfg)
    outputs = []
    for i, (cid, img) in enumerate(zip(classIds, images)):
        out = outputDir / f"class{cid}_{i}.png"
        writePng(out, img)
        outputs.append(out)
        logger.info("sampled class %d -> %s", cid, out)
    return outputs


def seededGeneratorState(geometry: dict, seed: int = 0,
                         key: str = "GeneratorV3SelfAttention") -> dict:
    """A generator state dict of numpy-seeded fp32 values, none zero: convs
    and linears at U(+-1/sqrt(fan_in)), norm scales near 1, GDN reparams near
    their init, cross-attention gates of both signs, VAR's attention scales
    near its init's log 4, the Neon codebook at its init scale. With these,
    the self-attention reaches the logits (the adaLN gates are not zero) and
    the Neon decoder's output stays finite. `key` names the generator."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in GeneratorRegistry.get(key)(**geometry)
                  .state_dict().items()}
    rng = np.random.default_rng(seed)
    state = {}
    for key, shape in shapes.items():
        name = key.split(".")[-1]
        if name == "weight" and len(shape) > 1:
            value = rng.uniform(-1, 1, shape) / np.sqrt(int(np.prod(shape[1:])))
        elif name in ("weight", "scale", "_temperature"):
            value = 1 + rng.uniform(-0.2, 0.2, shape)
        elif name == "bias":
            value = rng.uniform(-0.1, 0.1, shape)
        elif name == "beta":
            value = 1 + rng.uniform(0, 0.1, shape)
        elif name == "gamma":
            value = np.sqrt(0.1) * np.eye(shape[0]) + rng.uniform(0, 0.01, shape)
        elif "._freqEMA." in key:
            value = rng.uniform(0.1, 1, shape)
            value /= value.sum(-1, keepdims=True)
        elif name == "scaleLogit":
            value = np.log(4.0) + rng.uniform(-0.1, 0.1, shape)
        elif name == "gate":
            value = rng.uniform(0.3, 1.0, shape) * rng.choice([-1, 1], shape)
        elif name == "_codebook":
            value = rng.normal(size=shape) * np.sqrt(2 / (5 * shape[-1]))
        else:                          # embeddings, position tables, the scaffold codebook
            value = rng.normal(size=shape) * 0.5
        state[key] = torch.from_numpy(value.astype(np.float32))
    return state


def writeSeededGenerator(path, geometry: dict = GEN_STAGE2_NEON_A, seed: int = 0,
                         key: str = "GeneratorV3SelfAttention") -> Path:
    """A generator checkpoint of seeded weights (`seededGeneratorState`) in
    the JAX package's format, for runs that have no trained checkpoint;
    `key` is `GeneratorV3SelfAttention` or `GeneratorVAR`."""
    state = seededGeneratorState(geometry, seed, key)
    halving = halvingOf(geometry["size"])
    if key == "GeneratorVAR":
        flat = toJaxGeneratorParams(state, halving, geometry.get("depth", 24), var=True,
                                    attnL2Norm=geometry.get("attnL2Norm", True),
                                    denseNorm=geometry.get("denseNorm", False))
    else:
        flat = toJaxGeneratorParams(state, halving, geometry["depth"],
                                    denseNorm=geometry.get("denseNorm", False),
                                    textConditioned=geometry.get("textConditioned", False))
    config = {"model": {"key": key, "params": dict(geometry)}}
    return writeExport(path, flat, {"config": config, "version": mcquic_tpu_torch.__version__,
                                    "seed": seed})
