"""`python -m mcquic_tpu_torch train [-G] CONFIG`: training from a YAML config
(counterpart of `mcquic_tpu/train/cli.py`, reference `mcquic/train/cli.py:24-49`):
build the trainer, resume from `saveDir/latest` where a checkpoint is, and
train.
  * Stage 1 (the v1 Compressor, or Neon where the model has a `size`
    pyramid) trains on `trainSet`, tar shards (a glob, `.tar` or `.tar.gz`)
    or a folder of PNG and JPEG images, validates on `valSet` where it
    exists, and writes the deploy model beside the checkpoints.
  * Stage 2 (`gen`, `-G`) trains `GeneratorV3SelfAttention`, its NoAda
    variant or `GeneratorVAR` over the frozen tokenizer of `loadFrom`, on
    class folders of PNG or JPEG images or wnid-keyed tar shards
    (`data/imagenet_classes.py::getGenLoader`, 256x256 crops); it
    returns the checkpoint, which `generate` samples from.
A config's `externalLib` lists plugin files, which run before the trainer
is built (`registerExternal`, as `mcquic_tpu/train/cli.py:22-31` runs
them): they add models, optimizers, schedules, losses, hooks, value tuners
or generators to the registries of `utils/registry.py`, and the config
names them by key. A plugin written for the JAX package registers flax
modules into its registries and does not run here.

Several processes train one model data-parallel when MCQUIC_COORDINATOR
(`host:port`), MCQUIC_NUM_PROCESSES and MCQUIC_PROCESS_ID are set, one
process per card (`parallel.initDistributed`, as `mcquic_tpu/train/cli.py:54`
starts `jax.distributed`). `batchSize` is per process, so the global batch
is `batchSize` x the number of processes (`mcquic_tpu/train/cli.py:79-80`);
each process reads its share of the tar shards or class files
(`hostId`, `hostCount`), and only rank 0 writes the checkpoints and the
deploy model.
"""
import importlib.util
import logging
import sys
from pathlib import Path

from mcquic_tpu_torch import parallel
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data import getTrainLoader, getValLoader
from mcquic_tpu_torch.train.trainer import Trainer
from mcquic_tpu_torch.utils.convert import exportModel

logger = logging.getLogger("mcquic_tpu_torch.train")
STAGE2 = ("GeneratorV3SelfAttention", "GeneratorV3SelfAttentionNoAda", "GeneratorVAR")
GEN_CROP = 256                   # `mcquic_tpu/train/cli.py:88-90`


def registerExternal(paths):
    """Run each plugin file as a module named by its stem, which registers
    what it defines (`mcquic_tpu/train/cli.py:22-31`)."""
    for p in paths:
        p = Path(p)
        spec = importlib.util.spec_from_file_location(p.stem, p)
        module = importlib.util.module_from_spec(spec)
        sys.modules[p.stem] = module
        spec.loader.exec_module(module)
        logger.info("registered external lib %s", p)


def main(configPath, gen: bool = False, device="cuda") -> Path:
    """Train; returns the deploy model's path (stage 1) or the checkpoint's
    (stage 2)."""
    parallel.initDistributed(device)
    try:
        config = Config.load(str(configPath))
        registerExternal(config.Train.ExternalLib)
        if gen:
            return trainGenerator(config, device)
        if config.Model.Key in STAGE2:
            raise ValueError(f"{config.Model.Key} is a stage-2 model: train it with -G/--gen")
        return trainStage1(config, device)
    finally:
        parallel.destroy()


def trainStage1(config: Config, device="cuda") -> Path:
    train = config.Train
    trainer = Trainer(config, device=device)
    try:
        if trainer.tryResume():
            logger.info("auto-resumed training from %s", train.SaveDir)
        loaderFn = getTrainLoader(train.TrainSet, train.BatchSize, cropSize=trainer.inputSize,
                                  hostId=parallel.rank(), hostCount=parallel.world())
        valLoader = None
        if train.ValSet and Path(train.ValSet).exists():
            valLoader = getValLoader(train.ValSet)
        else:
            logger.warning("valSet %r not found: training without validation", train.ValSet)
        trainer.train(loaderFn, valLoader=valLoader)
    finally:
        trainer.close()
    export = Path(train.SaveDir) / "export.npz"
    if parallel.isMain():
        export = exportModel(export, trainer.variables(), config.serialize(), qp="train")
        logger.info("exported the deploy model to %s", export)
    return parallel.broadcastObject(export)


def trainGenerator(config: Config, device="cuda") -> Path:
    from mcquic_tpu_torch.data.imagenet_classes import getGenLoader
    from mcquic_tpu_torch.train.genTrainer import GenTrainer, checkGenerator
    train = config.Train
    checkGenerator(config.Model.Key, config.Model.Params)
    loaderFn = getGenLoader(train.TrainSet, train.BatchSize, cropSize=GEN_CROP,
                            hostId=parallel.rank(), hostCount=parallel.world())
    trainer = GenTrainer(config, device=device)
    try:
        if trainer.tryResume():
            logger.info("auto-resumed training from %s", train.SaveDir)
        trainer.train(loaderFn)
    finally:
        trainer.close()
    return Path(train.SaveDir) / "latest" / "saved.ckpt.npz"
