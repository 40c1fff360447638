"""Stage-1 training of the v1 Compressor or the Neon tokenizer on one card
or data-parallel over several processes (counterpart of `mcquic_tpu/train/trainer.py`, reference
`mcquic/train/trainer.py`):
  * the step of `train/state.py`: loss 0.5 distortion + 0.5 mse + 2 lpips,
    the gradient's global norm clipped at 4.0, a non-finite step skipped
    whole, and the run stopped on persistent skips;
  * a save every valFreq // 10 steps (at most every MCQUIC_SAVE_FREQ steps),
    validation through the real codec every valFreq with the best MS-SSIM
    kept, the CodebookReassign hook, auto-resume from the rotated `latest/`,
    and a save on SIGTERM;
  * npz checkpoints, or with MCQUIC_CKPT_BACKEND=orbax (or `ckptBackend`,
    read as the JAX trainer reads them, `mcquic_tpu/train/trainer.py:113-124`)
    sharded ones through `torch.distributed.checkpoint` under `saveDir/dcp`
    (`train/dcp_saver.py`, the counterpart of the JAX package's orbax
    saver): each rank writes its own shards of the optimizer's state
    asynchronously, at most 25 steps are kept, and a resume reads the
    latest step into the running sharding, at any world size. An unknown
    value is refused, and so is a saveDir holding a JAX run's `orbax/`,
    whose format needs tensorstore (`checkpointBackend`);
  * the learning rate of the world rule (`config.py::Train.scaledOptim`)
    at the global batch, `batchSize` x the number of processes.

Under data parallelism (`parallel`; `train/cli.py` starts it from the JAX
package's variables) each rank drives its own card and trains on its own
slice of the data, and the step averages the gradients (`train/state.py`).
Every rank resumes from the same checkpoint and runs the CodebookReassign
hook (the same generator and the same summed code counts give the same
codebooks). Only rank 0 holds the save directory (its lock, the rotation
of `latest/`, every save, the save on SIGTERM), validates and keeps
`best.ckpt.npz`, and logs; the other ranks wait for it at a barrier.

A config whose model carries a `size` pyramid trains Neon, whatever its key
says (`resolveStage1Model`); its input edge is `size[0] * 16` unless
`cropSize` is set, the v1 Compressor's 512.

Training runs in fp32 with TF32 off and cuDNN's deterministic algorithms
(`utils.exactFp32`), the numerics of the codec's paths. The initial weights come from a CPU generator seeded
with SEED (`models/compressor.py::initialize`), so one seed gives one start
on every device; the sampling and augmentation draw from a generator on the
training device seeded with SEED + 1.

The perceptual term is `loss/lpips.py::makeDefaultLpipsFn`, as the JAX
trainer assembles it (`mcquic_tpu/train/trainer.py:72-82`): the VGG16
backbone from MCQUIC_VGG16_WEIGHTS, the proxy under MCQUIC_LPIPS_PROXY=1,
or no term (with one loud warning) when neither is there; `lpipsFn=False`
opts out.

A checkpoint is the JAX package's layout: `step`, `params/...` and
`coder/...` under the flax names (`utils/convert.py::toJaxParams`),
`optState/NNNNN`, optax's state leaves in its order (`saver.py::OptaxLayout`),
and `rng`, so the JAX package resumes the port's checkpoints
(`Trainer.tryResume`) and reads them (`train/saver.py::loadTree`,
`validate/cli.py::loadAnyCheckpoint`), and the port resumes the JAX
package's. The torch generator's state is kept under `torch/rng`; a JAX
checkpoint's `rng` key seeds the generator instead.
"""
import logging
import math
import os
import signal
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

import mcquic_tpu_torch
from mcquic_tpu_torch import parallel
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
from mcquic_tpu_torch.loss.lpips import makeDefaultLpipsFn
from mcquic_tpu_torch.models.compressor import Neon, initialize
from mcquic_tpu_torch.ops.vq import draws
from mcquic_tpu_torch.train.dcp_saver import DcpSaver
from mcquic_tpu_torch.train.hooks import HookType, getAllHooks
from mcquic_tpu_torch.train.logging import MetricsLogger
from mcquic_tpu_torch.train.lrSchedulers import checkScheduleCoversBudget, getSchedule
from mcquic_tpu_torch.train.optim import getOptimizer
from mcquic_tpu_torch.train.saver import OptaxLayout, Saver, restoreGenerator, saveTree
from mcquic_tpu_torch.train.state import (codeUsage, makeTrainStep, reassignShapes,
                                          refreshCodebooks, trainableParameters)
from mcquic_tpu_torch.utils import exactFp32, resolveDevice
from mcquic_tpu_torch.utils.convert import (compressorMap, modelGeometry, neonMapOf, stateDictOf,
                                            toJaxParams)
from mcquic_tpu_torch.utils.registry import LossRegistry, ModelRegistry

logger = logging.getLogger("mcquic_tpu_torch.train")

SEED = 3407                 # reference train/utils.py:332


def resolveStage1Model(config: Config):
    """(model key, constructor kwargs) of a stage-1 config, resolved as
    `mcquic_tpu/train/trainer.py:398-434` resolves them: a `size` pyramid
    means Neon whatever the key says, and a list-valued k is read at its
    first entry; otherwise the config's key (the v1 Compressor, or a model
    a plugin registered), a uniform list-valued m read as its int."""
    geometry = modelGeometry({"config": config.serialize()})
    return ("Neon" if "size" in geometry else config.Model.Key), geometry


def modelMap(geometry: dict):
    """The stage-1 model's name map: Neon's or the v1 Compressor's."""
    if "size" in geometry:
        return neonMapOf(geometry)
    return compressorMap(len(geometry["k"]))


def geometryOf(model) -> dict:
    if isinstance(model, Neon):
        geometry = {"channel": model.channel, "k": model.k, "size": list(model.size)}
        if model.denseNorm:
            geometry["denseNorm"] = True
        return geometry
    return {"channel": model.channel, "m": model.m, "k": list(model.k)}


def checkpointBackend(saveDir, backend: Optional[str] = None) -> str:
    """`backend`, else MCQUIC_CKPT_BACKEND, else npz: `npz` (saveDir/latest)
    or `orbax`, which this package writes through torch.distributed.checkpoint
    (saveDir/dcp). Unknown values raise. A saveDir holding a JAX run's
    `orbax/` raises too, where this backend would resume from it (orbax's
    format needs tensorstore), and where npz finds no `latest/` beside it:
    either would otherwise start again from step 0 without a word."""
    backend = backend or os.environ.get("MCQUIC_CKPT_BACKEND", "npz")
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown ckptBackend {backend!r}")
    if saveDir and (Path(saveDir) / "orbax").is_dir():
        if backend == "orbax":
            raise ValueError(f"saveDir {saveDir} holds an orbax checkpoint (orbax/), whose format "
                             "needs tensorstore; this package resumes its own "
                             "torch.distributed.checkpoint steps (dcp/) and npz checkpoints")
        if not (Path(saveDir) / "latest").is_dir():
            raise ValueError(f"saveDir {saveDir} holds an orbax checkpoint (orbax/) and no "
                             "latest/; this package resumes npz checkpoints only")
    return backend


class Trainer:
    def __init__(self, config: Config, model=None, device="cuda", inputShape=None,
                 seed: int = SEED, lpipsFn=None, ckptBackend: Optional[str] = None):
        self._config = config
        train = config.Train
        self._device = parallel.localDevice(resolveDevice(device))
        self._world = parallel.world()
        self._main = parallel.isMain()
        if model is None:
            key, params = resolveStage1Model(config)
            model = initialize(ModelRegistry.get(key)(**params), torch.Generator().manual_seed(seed))
        self._geometry = geometryOf(model)
        self._model = model.to(self._device).train()
        self._dtype = next(self._model.parameters()).dtype      # fp32; fp64 in the tests
        edge = train.CropSize or (int(model.size[0]) * 16 if isinstance(model, Neon) else 512)
        self._inputShape = tuple(inputShape or (edge, edge))

        optimCfg = train.scaledOptim(self._world)
        self._baseLr = optimCfg.Params.get("lr", 1e-4)
        self._schedule = getSchedule(train.Schdr.Key, self._baseLr, train.Schdr.Params)
        self._names = [name for name, p in self._model.named_parameters() if p.requires_grad]
        self._optimizer = getOptimizer(optimCfg.Key, self._schedule, optimCfg.Params,
                                       trainableParameters(self._model))
        self._layout = OptaxLayout(modelMap(self._geometry), self._names)
        logger.debug("optimizer state on rank %d of %d: %d bytes", parallel.rank(), self._world,
                     self._optimizer.stateBytes())
        if lpipsFn is None:
            lpipsFn = makeDefaultLpipsFn(self._device)
        elif lpipsFn is False:
            lpipsFn = None
        self._lpipsFn = lpipsFn
        self._stepFn = makeTrainStep(self._model, self._optimizer, LossRegistry.get(train.Target)(),
                                     lpipsFn)
        self._step = 0
        self._generator = torch.Generator(device=self._device).manual_seed(seed + 1)

        # rank 0's Saver rotates the previous `latest/` away; every rank
        # resumes from where it went
        backend = checkpointBackend(train.SaveDir, ckptBackend)
        self._saver = Saver(train.SaveDir) if train.SaveDir and self._main else None
        self._dcp = DcpSaver(train.SaveDir) if backend == "orbax" and train.SaveDir else None
        self._mesh = None
        self._resumePath = parallel.broadcastObject(
            self._saver.PreviousCkpt if self._saver else None)
        self._bestDistortion = float("-inf")
        self._lastValExtras = {"pairs": [], "codes": None}
        self._hooks = getAllHooks(train.Hooks)

    # ----------------------------------------------------------------- state
    @property
    def model(self):
        return self._model

    @property
    def step(self) -> int:
        return self._step

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def inputSize(self) -> int:
        return self._inputShape[0]

    @property
    def totalStep(self) -> int:
        return int(self._config.Train.TotalStep)

    def _runHooks(self, phase: str, step: int):
        for hook in self._hooks[HookType(phase)]:
            hook(self, step)

    def variables(self) -> dict:
        """The model's `params/...` and `coder/...` under the flax names."""
        return toJaxParams(self._model.state_dict(), self._geometry)

    # ---------------------------------------------------------------- resume
    def tryResume(self) -> bool:
        """Resume from the latest DCP step under the orbax backend, else from
        the checkpoint the Saver rotated away, if any: the port's or the JAX
        package's."""
        if self._dcp is not None:
            return self._resumeDcp()
        path = self._resumePath
        if path is None or not Path(path).exists():
            return False
        flat, _ = Saver.load(path)
        self._model.load_state_dict(
            stateDictOf({k: v for k, v in flat.items() if k.startswith(("params/", "coder/"))},
                        self._geometry), strict=True)
        self._layout.load(self._optimizer, self._model.state_dict(), flat)
        self._step = int(flat["step"])
        restoreGenerator(self._generator, flat)
        logger.info("Resumed from %s at step %d", path, self._step)
        return True

    def _sharded(self, tensor: torch.Tensor, i: int):
        """Slot tensor `tensor` of parameter i as DCP keeps it: a DTensor
        sharded as ZeRO shards it, so that every rank's slice is written and
        a resume at another world size reshards; the tensor itself where it
        is whole on every rank."""
        axis = self._optimizer.axes[i]
        if axis is None:
            return tensor
        from torch.distributed.tensor import DTensor, Shard
        if self._mesh is None:
            from torch.distributed.device_mesh import init_device_mesh
            self._mesh = init_device_mesh(self._device.type, (self._world,))
        shape = self._optimizer.params[i].shape
        return DTensor.from_local(tensor, self._mesh, [Shard(axis)], run_check=False, shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    def _dcpState(self) -> dict:
        """What a DCP step holds, the npz checkpoint's state: the step, the
        model's state dict (its parameters and code frequencies), the
        optimizer's count and slots (this rank's shards) and the torch
        generator's state."""
        optimizer = self._optimizer
        slots = {slot: {name: self._sharded(t, i)
                        for i, (name, t) in enumerate(zip(self._names, tensors))}
                 for slot, tensors in optimizer.state.items()}
        return {"step": self._step, "model": self._model.state_dict(),
                "optimizer": {"count": optimizer.count, **slots},
                "rng": self._generator.get_state()}

    def _resumeDcp(self) -> bool:
        step = self._dcp.latestStep()
        if step is None:
            return False
        # the template's tensors are the model's and the optimizer's own (views,
        # and DTensors over this rank's slots): the load writes them in place
        state = self._dcp.restore(self._dcpState(), step)
        self._optimizer.count = int(state["optimizer"]["count"])
        self._step = int(state["step"])
        self._generator.set_state(state["rng"])
        logger.info("Resumed from %s at step %d", self._dcp.root / str(step), self._step)
        return True

    def checkpoint(self) -> Optional[dict]:
        """The JAX layout; `rng` is a key the JAX package resumes with, the
        port resumes its own generator from `torch/rng`. Every rank calls
        it (the optimizer's shards are gathered); rank 0 gets the
        checkpoint, the other ranks None."""
        optState = self._layout.leaves(self._optimizer, self._model.state_dict())
        if optState is None:
            return None
        return {"step": np.asarray(self._step, np.int32), **self.variables(), **optState,
                "rng": np.asarray([0, (SEED + 1 + self._step) & 0xFFFFFFFF], np.uint32),
                "torch/rng": self._generator.get_state().numpy()}

    def save(self, wait: bool = False):
        """Every rank takes part where the config names a saveDir: each
        writes its shards of a DCP step under the orbax backend (`wait`:
        until it is on disk), else rank 0 writes the gathered checkpoint
        (`checkpoint`)."""
        if not self._config.Train.SaveDir:
            return
        if self._dcp is not None:
            self._dcp.save(self._step, self._dcpState())
            if wait:
                self._dcp.waitUntilFinished()
            return
        flat = self.checkpoint()
        if self._saver is not None:
            self._saver.save(flat, {"config": self._config.serialize()})

    def close(self):
        """Wait for a DCP save in flight; release the save directory's lock."""
        if self._dcp is not None:
            self._dcp.waitUntilFinished()
        if self._saver is not None:
            self._saver.close()

    # ----------------------------------------------------------------- train
    def upload(self, batch: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if self._device.type == "cuda":
            return host.pin_memory().to(self._device, non_blocking=True)
        return host

    def trainStep(self, batch: np.ndarray) -> dict:
        """One step on a batch: uint8 NHWC (augmented on the device), or
        float NHWC in [-1, 1] taken as it is."""
        batch = np.asarray(batch)
        x = self.upload(batch if batch.dtype == np.uint8 else batch.astype(np.float32, copy=False))
        with exactFp32(deterministic=True):
            if x.dtype == torch.uint8:
                x = trainingTransform(x, augmentDraws(self._generator, x.shape[0]))
            else:
                x = x.permute(0, 3, 1, 2)
            metrics = self._stepFn(x.to(self._dtype), draws(self._generator))
        self._step += 1
        return metrics

    def train(self, loaderFn: Callable[[], Iterable], valLoader=None,
              onStep: Optional[Callable] = None, metricsLogger=None):
        train = self._config.Train
        total = train.TotalStep
        maxEpochs = max(int(train.Epoch or 0), 0) or None
        valFreq = train.ValFreq
        saveFreq = max(valFreq // 10, 1)
        envSave = os.environ.get("MCQUIC_SAVE_FREQ")
        if envSave:
            saveFreq = min(saveFreq, max(int(envSave), 1))
        if metricsLogger is None and onStep is None:
            metricsLogger = MetricsLogger()
        if onStep is None:
            onStep = metricsLogger.log

        stopRequested = []

        def onSigterm(signum, frame):
            if self._world > 1:
                # the save gathers the optimizer's shards from every rank, so
                # the ranks agree to stop at the end of a step (`anyRank`)
                logger.warning("SIGTERM: saving checkpoint at the end of this step")
                stopRequested.append(signum)
                return
            logger.warning("SIGTERM: saving checkpoint before exit")
            self.save(wait=True)
            raise SystemExit(143)

        try:
            previousHandler = signal.signal(signal.SIGTERM, onSigterm)
        except ValueError:                                # not the main thread
            previousHandler = None
        step = self._step
        checkScheduleCoversBudget(self._schedule, self._baseLr, step, total,
                                  strict=os.environ.get("MCQUIC_STRICT_SCHEDULE") == "1")
        epoch, badLogs, lastLog = 0, 0, time.time()
        try:
            self._runHooks("beforeRun", step)
            while step < total and (maxEpochs is None or epoch < maxEpochs):
                self._runHooks("epochStart", step)
                for batch in loaderFn():
                    self._runHooks("stepStart", step)
                    metrics = self.trainStep(batch)
                    step = self._step
                    if self._world > 1 and parallel.anyRank(bool(stopRequested), self._device):
                        self.save(wait=True)
                        raise SystemExit(143)
                    if step % 100 == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        if not math.isfinite(m["loss"]):
                            # skipped by the step's guard: fail only when it persists
                            if m["skipped"] >= 1 and badLogs < 2:
                                badLogs += 1
                                logger.warning("step %d: non-finite loss, update skipped by the "
                                               "step guard (%d consecutive)", step, badLogs)
                                lastLog = time.time()
                                continue
                            raise RuntimeError(f"Loss is NaN/Inf at step {step}: {m}")
                        badLogs = 0
                        m["lr"] = float(self._schedule(step))
                        m["stepsPerSec"] = 100 / (time.time() - lastLog)
                        lastLog = time.time()
                        if self._main:
                            if step % 1000 == 0:
                                m["codeUsage"] = self.codeUsage()
                            onStep(step, m)
                    self._runHooks("stepFinish", step)
                    if step % saveFreq == 0:
                        self.save()
                    if valLoader is not None and step % valFreq == 0:
                        if self._main:
                            self._validateAndKeepBest(valLoader, step, onStep, metricsLogger)
                        parallel.barrier()
                    if step >= total:
                        break
                epoch += 1
                self._runHooks("epochFinish", step)
            self.save()
            parallel.barrier()
            self._runHooks("afterRun", step)
        finally:
            if previousHandler is not None:
                signal.signal(signal.SIGTERM, previousHandler)
            self.close()
        return self

    def _validateAndKeepBest(self, valLoader, step: int, onStep, metricsLogger):
        results = self.validate(valLoader)
        logger.info("step %d validation: %s", step, results)
        onStep(step, {f"val/{k}": v for k, v in results.items()})
        if metricsLogger is not None:
            self._logValObservability(metricsLogger, step, self._lastValExtras)
        if self._saver is not None and results.get("msssim", 0) > self._bestDistortion:
            self._bestDistortion = results["msssim"]
            saveTree(self._saver.SaveDir / "best.ckpt.npz", self.variables(),
                     {"config": self._config.serialize(), "step": step,
                      "version": mcquic_tpu_torch.__version__})

    def _logValObservability(self, metricsLogger, step: int, extras: dict):
        """The code-frequency histograms, the code maps of the last image and
        the raw / restored pairs, in the order of
        `mcquic_tpu/train/trainer.py:360-374`."""
        from mcquic_tpu_torch.validate.validator import visualizeCodeMaps
        for i, freq in enumerate(self._model._quantizer.frequencies()):
            metricsLogger.histogram(step, f"freq/freqEMA{i}", freq.detach().cpu().numpy())
        if extras.get("codes"):
            metricsLogger.images(step, "val/codeMaps",
                                 [m[0] for m in visualizeCodeMaps(extras["codes"])])
        pairs = extras.get("pairs") or []
        if pairs:
            metricsLogger.images(step, "val/raw", [p[0] for p in pairs])
            metricsLogger.images(step, "val/restored", [p[1] for p in pairs])

    def validate(self, valLoader) -> dict:
        """The real codec's metrics with the current weights (reference
        trainer.py:495-529). The engine works on the live model and leaves
        its training mode and `requires_grad` as they are."""
        from mcquic_tpu_torch.models.engine import CompressorEngine
        from mcquic_tpu_torch.validate.validator import Validator
        validator = Validator(CompressorEngine(self._model, qp="train", device=self._device))
        results = validator.validate(valLoader)
        self._lastValExtras = validator.collected
        return results

    def reassignCodebooks(self) -> float:
        """Dead-codeword reassignment of every level, uniforms from the
        trainer's generator."""
        uniforms = [torch.rand(shape, generator=self._generator, device=self._device)
                    for shape in reassignShapes(self._model)]
        return float(refreshCodebooks(self._model, uniforms))

    def codeUsage(self) -> float:
        return codeUsage(self._model)
