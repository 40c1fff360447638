"""Stage-2 training of the class-conditional generator on one card or
data-parallel over several processes (counterpart of
`mcquic_tpu/train/genTrainer.py`, reference `mcquic/train/genTrainer.py`):
  * the step (`makeGenTrainStep`): the teacher-forced pass of
    `GeneratorV3SelfAttention.forward` (or its NoAda variant) or of
    `GeneratorVAR.forward` through the frozen Neon tokenizer, the gradient's
    global norm clipped at 2.0, a non-finite step skipped whole, the metrics
    `loss`, `gradNorm`, `skipped` and `ceLvNN`;
  * the frozen tokenizer: the `compressor.*` parameters have
    `requires_grad=False` and stay out of the optimizer (`optax.masked` in
    the JAX package, `_trainableMask`), so they stay bit-identical;
  * `loadFrom` in the model's params: a stage-1 checkpoint or export (the
    port's or the JAX package's, bf16 leaves upcast), or a reference torch
    stage-1 checkpoint, becomes the tokenizer;
  * saves every valFreq // 10 steps (at most MCQUIC_SAVE_FREQ), the hooks,
    auto-resume from the rotated `latest/`, and LAMB's growth warning;
  * under data parallelism (`parallel`), each rank's slice of the global
    batch, the gradients and metrics averaged over the ranks
    (`train/state.py::averageOverRanks`), and rank 0 alone holding the save
    directory and logging, as in the stage-1 trainer; the learning rate at
    the global batch (`Train.scaledOptim`).

The training pass runs in fp32 with TF32 off and cuDNN's deterministic
algorithms, with uint8 batches augmented
on the card by the generator's transform (`data/augment.py`, `gen=True`:
the gamma and the jitter, no flips), its draws from a generator seeded with
SEED + 1, as is `GeneratorVAR`'s condition drop (drawn at the global batch,
`ops/vq.py::draws`). The transformer attends through the plain attention,
K3 having no backward; the frozen encode runs K1 once per level.

The JAX package's `GenTrainer` applies the model without a "gumbel" rng, so
`GeneratorVAR`'s condition drop (`make_rng("gumbel")`) has no key there and
its stage-2 step does not run for VAR; the port's step is held to the JAX
package's model (`tests/test_torch_generator_var.py`).

The checkpoint is the JAX `GenTrainer`'s layout (`genTrainer.py:237-246`):
`step`, `params/...` and `coder/...` of the whole model under the flax names
(`utils/convert.py::toJaxGeneratorParams`), `optState/NNNNN` with
`optax.masked`'s leaves (moments of the trainable parameters only, in flax
order; `saver.py::OptaxLayout`) and `rng`; the port keeps its generator's
state under `torch/rng`. Checkpoints resume across packages, and
`python -m mcquic_tpu_torch generate` samples from them. The JAX
`GenTrainer` has no orbax backend, so MCQUIC_CKPT_BACKEND=orbax, which
gives the stage-1 `Trainer` its sharded checkpoints, is refused here.
"""
import inspect
import logging
import math
import os
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from mcquic_tpu_torch import parallel
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
from mcquic_tpu_torch.models.compressor import initialize, truncatedNormal
from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
from mcquic_tpu_torch.models.generator_var import GeneratorVAR
from mcquic_tpu_torch.ops.vq import draws
from mcquic_tpu_torch.train.hooks import HookType, getAllHooks
from mcquic_tpu_torch.train.lrSchedulers import getSchedule
from mcquic_tpu_torch.train.optim import getOptimizer
from mcquic_tpu_torch.train.saver import OptaxLayout, Saver, restoreGenerator
from mcquic_tpu_torch.train.state import averageOverRanks, globalNorm
from mcquic_tpu_torch.utils import exactFp32, resolveDevice
from mcquic_tpu_torch.utils.convert import (_applyMap, convertReference, generatorMapOf,
                                            halvingOf, loadTorchStateDict, modelGeometry,
                                            neonMapOf, readExport, toJaxGeneratorParams)
from mcquic_tpu_torch.utils.registry import GeneratorRegistry

logger = logging.getLogger("mcquic_tpu_torch.train.gen")

SEED = 3407


def makeGenTrainStep(model, optimizer, clipNorm: float = 2.0):
    """(images [n, 3, H, W] in [-1, 1], labels [n], draw) -> metrics;
    updates the model's trainable parameters and the optimizer in place.
    `draw` (shape -> uniforms) is `GeneratorVAR`'s condition drop; the other
    generators draw nothing and take None."""
    params = optimizer.params

    def step(images: torch.Tensor, labels: torch.Tensor, draw=None) -> dict:
        model.train()
        for p in params:
            p.grad = None
        _, loss, _, _, perLevel = model(images, labels) if draw is None else \
            model(images, labels, draw)
        loss.backward()
        grads, (loss, *perLevel) = averageOverRanks(params, [loss, *perLevel])
        gnorm = globalNorm(grads).detach()
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        if ok:
            with torch.no_grad():
                torch._foreach_mul_(grads, torch.clamp(clipNorm / torch.clamp_min(gnorm, 1e-12),
                                                       max=1.0))
                optimizer.step(grads)
        for p in params:
            p.grad = None
        return {"loss": loss, "gradNorm": gnorm, "skipped": 0.0 if ok else 1.0,
                **{f"ceLv{i:02d}": ce for i, ce in enumerate(perLevel)}}

    return step


def checkGenerator(key: str, params: dict):
    """Refuses a key other than the three generators, and a text-conditioned
    generator: the JAX package's trainer feeds it the loaders' class ids,
    which its caption projection cannot take (`capProj` is [capDim,
    hidden]; flax raises ScopeParamShapeError), and neither package's
    loaders read captions, so no trainer of either package steps one."""
    if key not in GeneratorRegistry:
        raise NotImplementedError(f"generator `{key}` does not train in this package (ported: "
                                  f"{sorted(GeneratorRegistry)})")
    if params.get("textConditioned"):
        raise ValueError(f"{key} with textConditioned=True takes [n, capDim] caption "
                         "embeddings; `train -G` feeds class ids from class folders or "
                         "wnid-keyed shards and reads no captions (the JAX package's "
                         "GenTrainer cannot step such a model either)")


def constructGenerator(key: str, params: dict):
    """The generator of a config, dropping params its class does not take
    (`genTrainer.py:79-94`)."""
    checkGenerator(key, params)
    # the NoAda class takes GeneratorV3SelfAttention's arguments
    cls = GeneratorVAR if key == "GeneratorVAR" else GeneratorV3SelfAttention
    known = set(inspect.signature(cls.__init__).parameters)
    known.discard("self")
    dropped = sorted(set(params) - known - {"loadFrom"})
    if dropped:
        logger.info("ignoring config params not taken by %s: %s", key, dropped)
    return GeneratorRegistry.get(key)(**{k: v for k, v in params.items() if k in known})


def loadCompressorParams(ckptPath, modelParams: dict = None) -> dict:
    """A stage-1 checkpoint or export (npz + json sidecar, the port's or the
    JAX package's; bf16 leaves upcast to fp32) -> its flat `params/...` and
    `coder/...` arrays. A reference (PyTorch) trainer checkpoint is
    converted as `mcquic_tpu/train/genTrainer.py:97-129` converts it: its
    `module._compressor.` prefix stripped (`utils/convert.py::loadTorchStateDict`)
    and the Neon of the generator config's `channel`, `k` and `size`
    (`modelParams`) loaded from it, so `loadFrom: <reference stage-1 ckpt>`
    works as it stands."""
    path = Path(ckptPath)
    try:
        flat, _ = readExport(path, ("params/", "coder/"))
        return flat
    except Exception as npzErr:
        try:
            stateDict = loadTorchStateDict(path)
        except Exception as torchErr:
            raise ValueError(f"loadFrom {path} is neither a readable npz export ({npzErr!r}) nor "
                             f"a torch checkpoint ({torchErr!r})") from npzErr
    if not modelParams or not {"channel", "k", "size"} <= set(modelParams):
        raise ValueError("loadFrom points at a torch checkpoint; converting it needs the "
                         "generator config's channel/k/size to rebuild the Neon geometry")
    flat = convertReference(stateDict, modelGeometry({"config": {"model": {"params": {
        key: modelParams[key] for key in ("channel", "k", "size", "denseNorm")
        if key in modelParams}}}}))
    logger.info("converted reference torch stage-1 checkpoint %s", path)
    return flat


@torch.no_grad()
def initializeGenerator(model, generator: torch.Generator):
    """The generator's training start with the JAX package's initializers'
    distributions (`models/generator.py`): the class, scaffold, position and
    level tables truncated normal with std sqrt(2 / (5 hidden)) (the
    transformer's position table 2 / (5 hidden)); dense kernels lecun-normal
    except the zero-initialized adaLN and condition embeddings and the
    final linear (0.02 of the tables' std); biases, gates zero; norms one;
    the scaffold convs U(+-1/sqrt(fan_in)). The tokenizer is drawn as a
    stage-1 Neon (`initialize`); `loadFrom` replaces it. A `GeneratorVAR`
    takes `initializeVar`."""
    if isinstance(model, GeneratorVAR):
        return initializeVar(model, generator)
    hs = model.hiddenSize
    std = math.sqrt(2 / (5 * hs))
    zeroDense = ("adaLN.weight", "capEmbed.weight", "finalAdaLN.weight")
    for key, p in model.named_parameters():
        if key.startswith("compressor."):
            continue
        shape = tuple(p.shape)
        name = key.split(".")[-1]
        if key in ("classEmbed", "scaffoldCodebook", "firstLevelPosEmbed", "levelEmbed"):
            value = truncatedNormal(shape, generator, p) * std
        elif key == "transformer.posEmbed":
            value = truncatedNormal(shape, generator, p) * (2 / (5 * hs))
        elif key == "transformer.finalLinear.weight":
            value = truncatedNormal(shape, generator, p) * (0.02 * std)
        elif key.endswith(zeroDense) or name in ("bias", "gate"):
            value = torch.zeros_like(p)
        elif key.startswith("_decoders."):
            bound = 1 / math.sqrt(int(np.prod(shape[1:])))
            value = (torch.rand(shape, generator=generator, device=p.device) * 2 - 1) * bound
        elif name == "weight" and len(shape) == 2:
            value = truncatedNormal(shape, generator, p) * (math.sqrt(1 / shape[1])
                                                             / 0.87962566103423978)
        elif name in ("weight", "scale"):
            value = torch.ones_like(p)
        else:
            raise KeyError(key)
        p.copy_(value.to(p.dtype))
    initialize(model.compressor, generator)
    return model


@torch.no_grad()
def initializeVar(model: GeneratorVAR, generator: torch.Generator):
    """`GeneratorVAR`'s training start with the JAX package's initializers'
    distributions (`models/generator_var.py:143-171`): the class, start,
    position and level tables truncated normal with std sqrt(1 / (3 C));
    the blocks' and the head's adaLN kernels zero; the other dense kernels
    lecun-normal, biases zero; the attention scales log 4. The tokenizer is
    drawn as a stage-1 Neon (`initialize`); `loadFrom` replaces it."""
    std = math.sqrt(1 / model.embedDim / 3)
    for key, p in model.named_parameters():
        if key.startswith("compressor."):
            continue
        shape = tuple(p.shape)
        name = key.split(".")[-1]
        if key in ("classEmb", "posStart", "pos1LC", "lvlEmbed"):
            value = truncatedNormal(shape, generator, p) * std
        elif key.endswith("adaLN.weight") or key == "headAda.weight" or name == "bias":
            value = torch.zeros_like(p)
        elif name == "scaleLogit":
            value = torch.full_like(p, math.log(4.0))
        elif name == "weight":
            value = truncatedNormal(shape, generator, p) * (math.sqrt(1 / shape[1])
                                                             / 0.87962566103423978)
        else:
            raise KeyError(key)
        p.copy_(value.to(p.dtype))
    initialize(model.compressor, generator)
    return model


class GenTrainer:
    def __init__(self, config: Config, model=None, device="cuda", seed: int = SEED):
        if os.environ.get("MCQUIC_CKPT_BACKEND") == "orbax":
            raise NotImplementedError(
                "MCQUIC_CKPT_BACKEND=orbax selects the stage-1 Trainer's sharded checkpoints; "
                "the stage-2 GenTrainer has no such backend, as the JAX package's GenTrainer has "
                "none: it saves and resumes npz checkpoints in saveDir/latest")
        self._config = config
        train = config.Train
        self._device = parallel.localDevice(resolveDevice(device))
        self._world = parallel.world()
        self._main = parallel.isMain()
        params = dict(config.Model.Params)
        loadFrom = params.pop("loadFrom", None)
        if model is None:
            model = initializeGenerator(constructGenerator(config.Model.Key, params),
                                        torch.Generator().manual_seed(seed))
            if loadFrom:
                self.loadCompressor(model, loadFrom, params)
        self._model = model.to(self._device).train()
        self._model.compressor.requires_grad_(False)
        self._names = [n for n, p in self._model.named_parameters() if p.requires_grad]
        if isinstance(model, GeneratorVAR):
            self._geometry = {"var": True, "halving": halvingOf(model.size),
                              "depth": model.depth, "attnL2Norm": model.attnL2Norm}
        else:
            self._geometry = {"halving": halvingOf(model.size), "depth": model.depth,
                              "useAda": model.transformer.useAda,
                              "qkNorm": model.transformer.blocks[0].attention.qkNorm}
        if model.compressor.denseNorm:
            self._geometry["denseNorm"] = True
        self._layout = OptaxLayout(generatorMapOf(self._geometry), self._names)

        optimCfg = train.scaledOptim(self._world)
        self._baseLr = optimCfg.Params.get("lr", 1e-4)
        self._schedule = getSchedule(train.Schdr.Key, self._baseLr, train.Schdr.Params)
        # LAMB's trust ratio grows small-init layers at most ~e^(lr * steps)
        # over a run (`genTrainer.py:148-166`)
        if optimCfg.Key in ("Lamb", "FusedLAMB") and self._baseLr * train.TotalStep < 2.0:
            logger.warning(
                "optimizer %s with lr*totalStep = %.3g < 2: LAMB's trust ratio grows small-init "
                "layers only ~e^(lr*steps) (x%.2f over this run); the logits head may stay at "
                "uniform CE for the whole budget. Use Adam at this scale, raise lr, or extend "
                "totalStep.", optimCfg.Key, self._baseLr * train.TotalStep,
                float(np.exp(self._baseLr * train.TotalStep)))
        self._optimizer = getOptimizer(optimCfg.Key, self._schedule, optimCfg.Params,
                                       [p for p in self._model.parameters() if p.requires_grad])
        logger.debug("optimizer state on rank %d of %d: %d bytes", parallel.rank(), self._world,
                     self._optimizer.stateBytes())
        self._stepFn = makeGenTrainStep(self._model, self._optimizer)
        self._step = 0
        self._generator = torch.Generator(device=self._device).manual_seed(seed + 1)
        self._saver = Saver(train.SaveDir) if train.SaveDir and self._main else None
        self._resumePath = parallel.broadcastObject(
            self._saver.PreviousCkpt if self._saver else None)
        self._hooks = getAllHooks(train.Hooks)

    @staticmethod
    def loadCompressor(model, path, modelParams: dict = None):
        """The frozen tokenizer's weights from a stage-1 checkpoint or export,
        or a reference torch checkpoint of the geometry in `modelParams`."""
        flat = loadCompressorParams(path, modelParams)
        geometry = {"size": model.size, "denseNorm": model.compressor.denseNorm}
        model.compressor.load_state_dict(_applyMap(neonMapOf(geometry), flat), strict=True)
        logger.info("loaded the frozen compressor from %s", path)

    @property
    def model(self):
        return self._model

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def step(self) -> int:
        return self._step

    @property
    def totalStep(self) -> int:
        return int(self._config.Train.TotalStep)

    def _runHooks(self, phase: str, step: int):
        for hook in self._hooks[HookType(phase)]:
            hook(self, step)

    def variables(self) -> dict:
        """The whole model's `params/...` and `coder/...` under the flax names."""
        return toJaxGeneratorParams(self._model.state_dict(), **self._geometry)

    def upload(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self._device.type == "cuda":
            return host.pin_memory().to(self._device, non_blocking=True)
        return host

    def trainStep(self, images: np.ndarray, labels: np.ndarray) -> dict:
        """One step: uint8 NHWC images (augmented on the device) or float
        NHWC in [-1, 1] taken as they are, and int class ids."""
        images = np.asarray(images)
        x = self.upload(images if images.dtype == np.uint8
                        else images.astype(np.float32, copy=False))
        y = self.upload(np.asarray(labels, np.int64))
        with exactFp32(deterministic=True):
            if x.dtype == torch.uint8:
                x = trainingTransform(x, augmentDraws(self._generator, x.shape[0]), gen=True)
            else:
                x = x.permute(0, 3, 1, 2)
            metrics = self._stepFn(x, y, draws(self._generator)
                                   if isinstance(self._model, GeneratorVAR) else None)
        self._step += 1
        return metrics

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self) -> Optional[dict]:
        """Every rank calls it (the optimizer's shards are gathered); rank 0
        gets the checkpoint, the other ranks None."""
        optState = self._layout.leaves(self._optimizer, self._model.state_dict())
        if optState is None:
            return None
        return {"step": np.asarray(self._step, np.int32), **self.variables(), **optState,
                "rng": np.asarray([0, (SEED + self._step) & 0xFFFFFFFF], np.uint32),
                "torch/rng": self._generator.get_state().numpy()}

    def save(self):
        """Every rank takes part (`checkpoint`) where the config names a
        saveDir; rank 0 writes."""
        if not self._config.Train.SaveDir:
            return
        flat = self.checkpoint()
        if self._saver is not None:
            self._saver.save(flat, {"config": self._config.serialize()})

    def close(self):
        """Release the save directory's lock."""
        if self._saver is not None:
            self._saver.close()

    def tryResume(self) -> bool:
        """Resume from the checkpoint the Saver rotated away, if any: the
        port's or the JAX package's."""
        path = self._resumePath
        if path is None or not Path(path).exists():
            return False
        flat, _ = Saver.load(path)
        self._model.load_state_dict(_applyMap(generatorMapOf(self._geometry), {
            k: v for k, v in flat.items() if k.startswith(("params/", "coder/"))}), strict=True)
        self._layout.load(self._optimizer, self._model.state_dict(), flat)
        self._step = int(flat["step"])
        restoreGenerator(self._generator, flat)
        logger.info("Resumed from %s at step %d", path, self._step)
        return True

    # ----------------------------------------------------------------- train
    def train(self, loaderFn: Callable[[], Iterable], onStep: Optional[Callable] = None):
        train = self._config.Train
        total = train.TotalStep
        saveFreq = max(train.ValFreq // 10, 1)
        envSave = os.environ.get("MCQUIC_SAVE_FREQ")
        if envSave:
            saveFreq = min(saveFreq, max(int(envSave), 1))
        step = self._step
        lastLog, badLogs = time.time(), 0
        try:
            self._runHooks("beforeRun", step)
            while step < total:
                self._runHooks("epochStart", step)
                for images, labels in loaderFn():
                    self._runHooks("stepStart", step)
                    metrics = self.trainStep(images, labels)
                    step = self._step
                    self._runHooks("stepFinish", step)
                    if step % 100 == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        if not math.isfinite(m["loss"]):
                            if m["skipped"] >= 1 and badLogs < 2:
                                badLogs += 1
                                logger.warning("step %d: non-finite loss, update skipped by the "
                                               "step guard (%d consecutive)", step, badLogs)
                                lastLog = time.time()
                                continue
                            raise RuntimeError(f"Loss is NaN/Inf at step {step}: {m}")
                        badLogs = 0
                        m["stepsPerSec"] = 100 / (time.time() - lastLog)
                        lastLog = time.time()
                        if self._main:
                            logger.info("step %d: %s", step, m)
                            if onStep is not None:
                                onStep(step, m)
                    if step % saveFreq == 0:
                        self.save()
                    if step >= total:
                        break
                self._runHooks("epochFinish", step)
            self.save()
            parallel.barrier()
            self._runHooks("afterRun", step)
        finally:
            self.close()
        return self
