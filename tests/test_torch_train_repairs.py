"""The stage-1 trainer's save cadence, checkpoint backend and validation
logging against the JAX trainer's (`mcquic_tpu/train/trainer.py`), and the
denseNorm refusal's pointer, at the tiny geometry of
`test_torch_train_cli.tinyConfig` on the CPU:

  * MCQUIC_SAVE_FREQ caps the save interval (`:240-243`);
  * MCQUIC_CKPT_BACKEND: an unknown value raises with the JAX trainer's
    wording (`:118-124`), `orbax` selects the port's sharded checkpoints
    through torch.distributed.checkpoint under `saveDir/dcp`
    (`tests/test_torch_dcp.py` trains and resumes with them), and a saveDir
    holding only a JAX run's `orbax/` raises instead of starting from step 0;
  * a validation logs the frequency histograms, `val/codeMaps`, `val/raw`
    and `val/restored`, in the order of `_logValObservability` (`:360-374`);
  * a denseNorm Neon is refused citing ROADMAP A10.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data import getValLoader
from mcquic_tpu_torch.train.trainer import Trainer
from test_torch_train_cli import tinyConfig


class RecordingLogger:
    def __init__(self):
        self.calls = []

    def log(self, step, metrics):
        self.calls.append(("log", step, sorted(metrics)))

    def histogram(self, step, name, values):
        self.calls.append(("histogram", step, name))

    def images(self, step, name, images):
        self.calls.append(("images", step, name, [np.asarray(i) for i in images]))


def _trainer(tmp_path, **kwargs):
    return Trainer(Config.load(str(tinyConfig(tmp_path, **kwargs))), device="cpu", lpipsFn=False)


def _countSaves(trainer, monkeypatch, totalStep):
    """Steps at which `Trainer.train` saves, with the step stubbed out."""
    saves = []
    monkeypatch.setattr(trainer, "save", lambda: saves.append(trainer.step))

    def step(batch):
        trainer._step += 1
        return {"loss": torch.tensor(1.0), "skipped": torch.tensor(0.0)}

    monkeypatch.setattr(trainer, "trainStep", step)
    batches = [np.zeros((2, 64, 64, 3), np.uint8)] * totalStep
    trainer.train(lambda: iter(batches), onStep=lambda step, metrics: None)
    return saves


@pytest.mark.parametrize("saveFreq, want", [(None, [12]), ("3", [3, 6, 9, 12, 12]),
                                            ("1000", [12])])
def test_save_freq_caps_the_save_interval(tmp_path, monkeypatch, saveFreq, want):
    """valFreq 1000 saves every 100 steps; MCQUIC_SAVE_FREQ 3 every 3, and a
    larger value changes nothing (`mcquic_tpu/train/trainer.py:240-243`);
    the last save is the run's end."""
    if saveFreq is None:
        monkeypatch.delenv("MCQUIC_SAVE_FREQ", raising=False)
    else:
        monkeypatch.setenv("MCQUIC_SAVE_FREQ", saveFreq)
    trainer = _trainer(tmp_path, totalStep=12, valFreq=1000)
    assert _countSaves(trainer, monkeypatch, 12) == want


def test_ckpt_backend_unknown_and_orbax_are_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("MCQUIC_CKPT_BACKEND", "zarr")
    with pytest.raises(ValueError, match="unknown ckptBackend 'zarr'"):
        _trainer(tmp_path)
    monkeypatch.setenv("MCQUIC_CKPT_BACKEND", "orbax")
    trainer = _trainer(tmp_path)
    assert trainer._dcp.root == (tmp_path / "saved" / "dcp").absolute()
    assert not trainer.tryResume() and trainer.step == 0
    trainer.close()
    monkeypatch.setenv("MCQUIC_CKPT_BACKEND", "npz")
    trainer = _trainer(tmp_path)
    assert trainer._dcp is None
    trainer.close()


def test_ckpt_backend_refuses_a_save_dir_of_orbax_checkpoints_only(tmp_path, monkeypatch):
    """A JAX run's saveDir with `orbax/` and no `latest/` would start again
    from step 0; with `latest/` beside it the npz checkpoint resumes."""
    monkeypatch.delenv("MCQUIC_CKPT_BACKEND", raising=False)
    (tmp_path / "saved" / "orbax" / "7").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax checkpoint"):
        _trainer(tmp_path)
    (tmp_path / "saved" / "latest").mkdir()
    trainer = _trainer(tmp_path)
    assert not trainer.tryResume() and trainer.step == 0
    trainer.close()


def test_validation_logs_code_maps_and_restored_as_the_jax_trainer(tmp_path, monkeypatch):
    from mcquic_tpu.train.trainer import Trainer as JaxTrainer
    from mcquic_tpu.validate.validator import visualizeCodeMaps as jaxVisualize
    monkeypatch.delenv("MCQUIC_CKPT_BACKEND", raising=False)
    trainer = _trainer(tmp_path)
    try:
        ours = RecordingLogger()
        trainer._validateAndKeepBest(getValLoader(tmp_path / "pngs"), 2, ours.log, ours)
    finally:
        trainer.close()
    kinds = [c[2] for c in ours.calls if c[0] != "log"]
    assert kinds == ["freq/freqEMA0", "freq/freqEMA1", "val/codeMaps", "val/raw", "val/restored"]
    extras = trainer._lastValExtras
    codeMaps = next(c[3] for c in ours.calls if c[0] == "images" and c[2] == "val/codeMaps")
    want = [m[0] for m in jaxVisualize(extras["codes"])]
    assert len(codeMaps) == len(want) == 4                     # 2 levels x m 2
    for a, b in zip(codeMaps, want):
        np.testing.assert_array_equal(a, b)
    restored = next(c[3] for c in ours.calls if c[0] == "images" and c[2] == "val/restored")
    assert len(restored) == 3 and all(r.dtype == np.uint8 for r in restored)

    # the JAX trainer's logging of the same payload: the same image names in order
    theirs = RecordingLogger()
    freqs = {f"level{i}": {"freqEMA": f.numpy()}
             for i, f in enumerate(trainer.model._quantizer.frequencies())}
    fake = SimpleNamespace(_state=SimpleNamespace(coder=freqs))
    JaxTrainer._logValObservability(fake, theirs, 2, extras)
    assert [c[2] for c in theirs.calls if c[0] == "images"] == [k for k in kinds if k.startswith("val/")]
    assert sum(c[0] == "histogram" for c in theirs.calls) == 2


def test_dense_norm_refusal_cites_roadmap_a10():
    """A10 is done: the geometry keeps denseNorm and builds the GroupNorm
    Neon. What is still refused is what flax refuses too: a denseNorm Neon
    whose wide stages cannot take 32 GroupNorm groups (channel 8)."""
    from mcquic_tpu_torch.models.compressor import buildModel
    from mcquic_tpu_torch.utils.convert import modelGeometry
    meta = {"config": {"model": {"key": "Neon", "params": {
        "channel": 8, "k": 16, "size": [2, 1, 1], "denseNorm": True}}}}
    geometry = modelGeometry(meta)
    assert geometry["denseNorm"] is True
    with pytest.raises(ValueError, match="divisible by num_groups"):
        buildModel(geometry)
    geometry["channel"] = 32
    norms = [m for m in buildModel(geometry).modules() if isinstance(m, torch.nn.GroupNorm)]
    assert norms and all(m.eps == 1e-6 for m in norms)
