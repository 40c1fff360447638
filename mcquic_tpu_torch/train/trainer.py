"""Stage-1 training of the v1 Compressor on one card (counterpart of
`mcquic_tpu/train/trainer.py`, reference `mcquic/train/trainer.py`):
  * the step of `train/state.py`: loss 0.5 distortion + 0.5 mse + 2 lpips,
    the gradient's global norm clipped at 4.0, a non-finite step skipped
    whole, and the run stopped on persistent skips;
  * a save every valFreq // 10 steps, validation through the real codec
    every valFreq with the best MS-SSIM kept, the CodebookReassign hook,
    auto-resume from the rotated `latest/`, and a save on SIGTERM;
  * the learning rate of the world rule (`config.py::Train.scaledOptim`)
    at one card.

Training runs in fp32 with TF32 off (`utils.exactFp32`), the numerics of
the codec's paths. The initial weights come from a CPU generator seeded
with SEED (`models/compressor.py::initialize`), so one seed gives one start
on every device; the sampling and augmentation draw from a generator on the
training device seeded with SEED + 1.

LPIPS is not ported yet (ROADMAP): its VGG16 backbone is not in the repo
either, and the JAX trainer then trains without the term too
(`mcquic_tpu/loss/lpips.py:162-192`), which is what this trainer does.

A checkpoint is the JAX package's layout: `step`, `params/...` and
`coder/...` under the flax names (`utils/convert.py::toJaxParams`) and
`optState/NNNNN`, optax's state leaves in its order, so the JAX package
reads the port's checkpoints (`train/saver.py::loadTree`,
`validate/cli.py::loadAnyCheckpoint`) and the port resumes the JAX
package's. The torch generator's state is kept under `torch/rng`; a JAX
checkpoint's `rng` key seeds the generator instead.
"""
import logging
import math
import os
import signal
import time
from pathlib import Path
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

import mcquic_tpu_torch
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data.augment import augmentDraws, trainingTransform
from mcquic_tpu_torch.loss import MsSSIM, PSNR
from mcquic_tpu_torch.models.compressor import Compressor, initialize
from mcquic_tpu_torch.ops.vq import draws
from mcquic_tpu_torch.train.hooks import HookType, getAllHooks
from mcquic_tpu_torch.train.logging import MetricsLogger
from mcquic_tpu_torch.train.lrSchedulers import checkScheduleCoversBudget, getSchedule
from mcquic_tpu_torch.train.optim import Adam, getOptimizer
from mcquic_tpu_torch.train.saver import Saver, saveTree
from mcquic_tpu_torch.train.state import (codeUsage, makeTrainStep, refreshCodebooks,
                                          trainableParameters)
from mcquic_tpu_torch.utils import exactFp32, resolveDevice
from mcquic_tpu_torch.utils.convert import (compressorMap, modelGeometry, stateDictOf,
                                            toJaxParams)

logger = logging.getLogger("mcquic_tpu_torch.train")

SEED = 3407                 # reference train/utils.py:332
DISTORTIONS = {"MsSSIM": MsSSIM, "PSNR": PSNR}


def resolveStage1Model(config: Config):
    """(model key, constructor kwargs) of a stage-1 config, resolved as
    `mcquic_tpu/train/trainer.py:398-434` resolves them; a `size` pyramid
    means Neon, whose training is not ported yet."""
    geometry = modelGeometry({"config": config.serialize()})
    if "size" in geometry:
        raise NotImplementedError("Neon (a `size` pyramid) trains in the JAX package only; its "
                                  "training is ROADMAP A3 of this package")
    return "Compressor", geometry


class Trainer:
    def __init__(self, config: Config, model: Compressor = None, device="cuda",
                 inputShape=None, seed: int = SEED):
        self._config = config
        train = config.Train
        self._device = resolveDevice(device)
        if model is None:
            _, params = resolveStage1Model(config)
            model = initialize(Compressor(**params), torch.Generator().manual_seed(seed))
        self._geometry = {"channel": model.channel, "m": model.m, "k": list(model.k)}
        self._model = model.to(self._device).train()
        edge = train.CropSize or 512
        self._inputShape = tuple(inputShape or (edge, edge))

        optimCfg = train.scaledOptim(1)
        self._baseLr = optimCfg.Params.get("lr", 1e-4)
        self._schedule = getSchedule(train.Schdr.Key, self._baseLr, train.Schdr.Params)
        self._names = [name for name, p in self._model.named_parameters() if p.requires_grad]
        self._optimizer = getOptimizer(optimCfg.Key, self._schedule, optimCfg.Params,
                                       trainableParameters(self._model))
        if train.Target not in DISTORTIONS:
            raise KeyError(f"unknown target {train.Target!r}; known: {sorted(DISTORTIONS)}")
        logger.warning("LPIPS is not ported: the 2x-weighted perceptual term trains as zero, as "
                       "the JAX trainer's does without its VGG16 backbone")
        self._stepFn = makeTrainStep(self._model, self._optimizer, DISTORTIONS[train.Target]())
        self._step = 0
        self._generator = torch.Generator(device=self._device).manual_seed(seed + 1)

        # the Saver rotates the previous `latest/` away; resume reads it there
        self._saver = Saver(train.SaveDir) if train.SaveDir else None
        self._resumePath = self._saver.PreviousCkpt if self._saver else None
        self._bestDistortion = float("-inf")
        self._lastValExtras = {"pairs": [], "codes": None}
        self._hooks = getAllHooks(train.Hooks)

    # ----------------------------------------------------------------- state
    @property
    def model(self) -> Compressor:
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

    def _optaxOrder(self) -> List[int]:
        """Indices of the trainable parameters in the order of their flax
        leaves (`jax.tree_util` sorts dict keys at every level)."""
        keys = [tuple(key.split("/")) for key in self._flaxKeys()]
        return sorted(range(len(keys)), key=keys.__getitem__)

    def _flaxKeys(self) -> List[str]:
        entries = compressorMap(len(self._geometry["k"])).entries
        return [entries[name][0] for name in self._names]

    def _optState(self) -> dict:
        """The optimizer's state as optax's leaves: [count, mu..., nu...,
        count] for the Adam family, [trace..., count] or [count] for SGD."""
        order, keys = self._optaxOrder(), self._flaxKeys()

        def leaves(tensors):
            flat = toJaxParams({**self._model.state_dict(), **dict(zip(self._names, tensors))},
                               self._geometry)
            return [flat[keys[i]].astype(np.float32) for i in order]

        count = np.asarray(self._optimizer.count, np.int32)
        state = self._optimizer.state
        if isinstance(self._optimizer, Adam):
            out = [count, *leaves(state["mu"]), *leaves(state["nu"]), count]
        else:
            out = [*(leaves(state["trace"]) if "trace" in state else []), count]
        return {f"optState/{i:05d}": leaf for i, leaf in enumerate(out)}

    def _loadOptState(self, flat: dict):
        """The inverse of `_optState`, for the port's and the JAX package's
        checkpoints."""
        leaves = [flat[k] for k in sorted(k for k in flat if k.startswith("optState/"))]
        slots, n = list(self._optimizer.state), len(self._names)
        adam = isinstance(self._optimizer, Adam)
        if len(leaves) != (2 * n + 2 if adam else len(slots) * n + 1):
            raise ValueError(f"optimizer state layout changed ({len(leaves)} leaves for {n} "
                             f"parameters); cannot resume")
        order, keys = self._optaxOrder(), self._flaxKeys()
        body = leaves[1:-1] if adam else leaves[:-1]
        for s, slot in enumerate(slots):
            moments = {keys[i]: body[s * n + j] for j, i in enumerate(order)}
            tensors = stateDictOf({**self.variables(), **moments}, self._geometry)
            with torch.no_grad():
                for name, t in zip(self._names, self._optimizer.state[slot]):
                    t.copy_(tensors[name])
        self._optimizer.count = int(leaves[-1])

    # ---------------------------------------------------------------- resume
    def tryResume(self) -> bool:
        """Resume from the checkpoint the Saver rotated away, if any: the
        port's or the JAX package's."""
        path = self._resumePath
        if path is None or not Path(path).exists():
            return False
        flat, _ = Saver.load(path)
        self._model.load_state_dict(
            stateDictOf({k: v for k, v in flat.items() if k.startswith(("params/", "coder/"))},
                        self._geometry), strict=True)
        self._loadOptState(flat)
        self._step = int(flat["step"])
        if "torch/rng" in flat:
            self._generator.set_state(torch.from_numpy(flat["torch/rng"]))
        elif "rng" in flat:
            key = np.asarray(flat["rng"]).astype(np.uint64)
            self._generator.manual_seed(int((key[0] << np.uint64(32)) | key[1]))
        logger.info("Resumed from %s at step %d", path, self._step)
        return True

    def checkpoint(self) -> dict:
        return {"step": np.asarray(self._step, np.int32), **self.variables(), **self._optState(),
                "torch/rng": self._generator.get_state().numpy()}

    def save(self):
        if self._saver is not None:
            self._saver.save(self.checkpoint(), {"config": self._config.serialize()})

    def close(self):
        """Release the save directory's lock."""
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
        with exactFp32():
            if x.dtype == torch.uint8:
                x = trainingTransform(x, augmentDraws(self._generator, x.shape[0]))
            else:
                x = x.permute(0, 3, 1, 2)
            metrics = self._stepFn(x, draws(self._generator))
        self._step += 1
        return metrics

    def train(self, loaderFn: Callable[[], Iterable], valLoader=None,
              onStep: Optional[Callable] = None, metricsLogger=None):
        train = self._config.Train
        total = train.TotalStep
        maxEpochs = max(int(train.Epoch or 0), 0) or None
        valFreq = train.ValFreq
        saveFreq = max(valFreq // 10, 1)
        if metricsLogger is None and onStep is None:
            metricsLogger = MetricsLogger()
        if onStep is None:
            onStep = metricsLogger.log

        def onSigterm(signum, frame):
            logger.warning("SIGTERM: saving checkpoint before exit")
            self.save()
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
                        if step % 1000 == 0:
                            m["codeUsage"] = self.codeUsage()
                        lastLog = time.time()
                        onStep(step, m)
                    self._runHooks("stepFinish", step)
                    if step % saveFreq == 0:
                        self.save()
                    if valLoader is not None and step % valFreq == 0:
                        self._validateAndKeepBest(valLoader, step, onStep, metricsLogger)
                    if step >= total:
                        break
                epoch += 1
                self._runHooks("epochFinish", step)
            self.save()
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
            for i, freq in enumerate(self._model._quantizer.frequencies()):
                metricsLogger.histogram(step, f"freq/freqEMA{i}", freq.detach().cpu().numpy())
            pairs = self._lastValExtras.get("pairs") or []
            if pairs:
                metricsLogger.images(step, "val/raw", [p[0] for p in pairs])
        if self._saver is not None and results.get("msssim", 0) > self._bestDistortion:
            self._bestDistortion = results["msssim"]
            saveTree(self._saver.SaveDir / "best.ckpt.npz", self.variables(),
                     {"config": self._config.serialize(), "step": step,
                      "version": mcquic_tpu_torch.__version__})

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
        uniforms = [torch.rand(tuple(f.shape), generator=self._generator, device=self._device)
                    for f in self._model._quantizer.frequencies()]
        return float(refreshCodebooks(self._model, uniforms))

    def codeUsage(self) -> float:
        return codeUsage(self._model)
