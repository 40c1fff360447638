"""`python -m mcquic_tpu_torch train`: stage-1 training of the v1 Compressor
from a YAML config (counterpart of `mcquic_tpu/train/cli.py`, reference
`mcquic/train/cli.py:24-49`): build the trainer, resume from
`saveDir/latest` where a checkpoint is, train on the PNG folder `trainSet`,
validate on `valSet` where it exists, and write the deploy model beside the
checkpoints. A config's `externalLib` (user files that extend the JAX
package's registries) is refused: this package has no registries to extend.
"""
import logging
from pathlib import Path

from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data import getTrainLoader, getValLoader
from mcquic_tpu_torch.train.trainer import Trainer
from mcquic_tpu_torch.utils.convert import exportModel

logger = logging.getLogger("mcquic_tpu_torch.train")
STAGE2 = ("GeneratorV3SelfAttention", "GeneratorV3SelfAttentionNoAda", "GeneratorVAR")


def main(configPath, device="cuda") -> Path:
    """Train, then export; returns the deploy model's path."""
    config = Config.load(str(configPath))
    if config.Model.Key in STAGE2:
        raise NotImplementedError(f"{config.Model.Key} (stage-2) training is ROADMAP A4 of this "
                                  "package; it trains in the JAX package")
    train = config.Train
    if train.ExternalLib:
        raise NotImplementedError(f"externalLib {train.ExternalLib} is not supported by this package")
    trainer = Trainer(config, device=device)
    try:
        if trainer.tryResume():
            logger.info("auto-resumed training from %s", train.SaveDir)
        loaderFn = getTrainLoader(train.TrainSet, train.BatchSize, cropSize=trainer.inputSize)
        valLoader = None
        if train.ValSet and Path(train.ValSet).exists():
            valLoader = getValLoader(train.ValSet)
        else:
            logger.warning("valSet %r not found: training without validation", train.ValSet)
        trainer.train(loaderFn, valLoader=valLoader)
    finally:
        trainer.close()
    export = exportModel(Path(train.SaveDir) / "export.npz", trainer.variables(),
                         config.serialize(), qp="train")
    logger.info("exported the deploy model to %s", export)
    return export
