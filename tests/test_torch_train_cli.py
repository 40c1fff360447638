"""The port's trainer, checkpoints and `train` CLI on the CPU, at channel 8,
m 2, k (16, 8) on 64x64 crops.

  * A port checkpoint reads in `mcquic_tpu.train.saver.loadTree` with the
    JAX package's tree: `params` and `coder` under the flax names, `step`,
    and `optState` as optax's leaves; both packages' `validate` loaders
    (`loadAnyCheckpoint`) take it.
  * A JAX package checkpoint (optax Adam state after an update) resumes in
    the port: parameters, moments, count and step.
  * A port checkpoint resumes to the same step, parameters, moments and
    generator state.
  * `python -m mcquic_tpu_torch train cfg.yaml --device cpu` runs 2 steps
    with the reassign hook and a validation, writes a checkpoint and an
    export, and the export compresses and restores through `--local`.

Neon and the generator through the CLI, and the CLI's refusals and inputs,
are in tests/test_torch_train_cli_v2.py (a file of its own, so that xdist's
loadfile runs the two halves on two workers); the helpers both use are
here.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcquic_tpu.train.lrSchedulers import getSchedule as jaxGetSchedule
from mcquic_tpu.train.saver import loadTree, saveTree as jaxSaveTree
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data.png import readPng, writePng
from mcquic_tpu_torch.train.trainer import Trainer
from test_torch_weights import flattenTree, jaxVariables, portModel, randomStateDict

ROOT = Path(__file__).resolve().parent.parent
TINY = {"channel": 8, "m": 2, "k": [16, 8]}


def tinyConfig(tmp: Path, totalStep: int = 2, valFreq: int = 2, hookFreq: int = 1) -> Path:
    """A training folder of three PNG crops of the photo and a config over it."""
    pngs = tmp / "pngs"
    pngs.mkdir(exist_ok=True)
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    for i in range(3):
        writePng(pngs / f"{i}.png", img[i * 120:i * 120 + 256, i * 90:i * 90 + 300])
    config = tmp / "cfg.yaml"
    config.write_text(f"""# tiny stage-1 run
model: {{key: Compressor, params: {{channel: 8, m: 2, k: [16, 8]}}}}
train:
  totalStep: {totalStep}
  batchSize: 2
  cropSize: 64
  epoch: 100
  valFreq: {valFreq}
  trainSet: {pngs}
  valSet: {pngs}
  saveDir: {tmp / 'saved'}
  target: PSNR
  optim: {{key: Adam, params: {{lr: 1.0e-4}}}}
  schdr:
    key: CosineAnnealingWarmupRestarts
    params: {{first_cycle_steps: 10, warmup_steps: 1, lrScaleRatio: 0.001}}
  hooks:
    - {{key: CodebookReassign, params: {{freq: {hookFreq}}}}}
  gpu: {{gpus: 1, vRam: -1, wantsMore: false}}
""")
    return config


def _batch(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port trainer after two steps and a reassignment, saved and closed."""
    tmp = tmp_path_factory.mktemp("trained")
    trainer = Trainer(Config.load(str(tinyConfig(tmp))), device="cpu")
    for seed in range(2):
        assert trainer.trainStep(_batch(seed))["skipped"] == 0.0
    trainer.reassignCodebooks()
    trainer.save()
    trainer.close()
    return tmp, trainer


def test_port_checkpoint_reads_in_the_jax_package(trained):
    tmp, trainer = trained
    tree, meta = loadTree(tmp / "saved" / "latest" / "saved.ckpt.npz")
    assert meta["config"]["model"]["key"] == "Compressor" and "version" in meta
    assert int(tree["step"]) == 2
    want = flattenTree(jaxVariables(randomStateDict(**TINY), **TINY))
    got = flattenTree({"params": tree["params"], "coder": tree["coder"]})
    assert set(got) == set(want)
    for key, value in got.items():
        assert value.shape == want[key].shape, key
    ours = trainer.variables()
    for key in got:
        np.testing.assert_array_equal(got[key], ours[key])
    # both packages' validate loaders take it
    from mcquic_tpu.validate.cli import loadAnyCheckpoint as jaxLoadAny
    from mcquic_tpu_torch.validate.cli import loadAnyCheckpoint
    variables, jaxConfig, _ = jaxLoadAny(tmp / "saved" / "latest" / "saved.ckpt.npz")
    flat, _ = loadAnyCheckpoint(tmp / "saved" / "latest" / "saved.ckpt.npz")
    assert jaxConfig.Model.Params == {"channel": 8, "m": 2, "k": [16, 8]}
    assert flattenTree(variables).keys() == flat.keys() == got.keys()
    # optax's Adam layout: count, mu, nu (flax leaf order), count
    leaves = [tree["optState"][k] for k in sorted(tree["optState"])]
    params = jax.tree_util.tree_leaves(tree["params"])
    assert len(leaves) == 2 * len(params) + 2
    assert int(leaves[0]) == int(leaves[-1]) == 2
    for mu, p in zip(leaves[1:1 + len(params)], params):
        assert mu.shape == p.shape


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    config = Config.load(str(tinyConfig(tmp_path)))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       jaxVariables(randomStateDict(**TINY, seed=3), **TINY))
    schedule = jaxGetSchedule("CosineAnnealingWarmupRestarts", 3.5355339e-05,
                              {"first_cycle_steps": 10, "warmup_steps": 1, "lrScaleRatio": 0.001})
    tx = optax.adam(schedule)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.random.default_rng(p.size).normal(size=p.shape), jnp.float32),
        params)
    _, optState = tx.update(grads, tx.init(params), params)
    leaves = jax.tree_util.tree_leaves(optState)
    jaxSaveTree(tmp_path / "saved" / "latest" / "saved.ckpt.npz",
                {"step": np.asarray(5, np.int32), "params": variables["params"],
                 "coder": variables["coder"],
                 "optState": {f"{i:05d}": np.asarray(l) for i, l in enumerate(leaves)},
                 "rng": np.asarray(jax.random.PRNGKey(9))},
                {"config": config.serialize()})
    trainer = Trainer(config, model=portModel(randomStateDict(**TINY), **TINY).float(),
                      device="cpu")
    try:
        assert trainer.tryResume()
        assert trainer.step == 5 and trainer.optimizer.count == 1
        flat = flattenTree(variables)
        for key, value in trainer.variables().items():
            np.testing.assert_array_equal(value, flat[key], err_msg=key)
        resumed = trainer.checkpoint()
        for i, leaf in enumerate(leaves):
            np.testing.assert_array_equal(resumed[f"optState/{i:05d}"], np.asarray(leaf),
                                          err_msg=f"optState leaf {i}")
        assert trainer.trainStep(_batch())["skipped"] == 0.0 and trainer.step == 6
    finally:
        trainer.close()


def test_port_checkpoint_resumes_to_the_same_state(trained):
    tmp, first = trained
    second = Trainer(Config.load(str(tmp / "cfg.yaml")), device="cpu")
    try:
        assert second.tryResume()
        assert second.step == first.step == 2 and second.optimizer.count == first.optimizer.count
        for (name, a), b in zip(first.model.state_dict().items(), second.model.state_dict().values()):
            torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
        for slot in ("mu", "nu"):
            for a, b in zip(first.optimizer.state[slot], second.optimizer.state[slot]):
                torch.testing.assert_close(b, a, rtol=0, atol=0)
        assert torch.equal(first._generator.get_state(), second._generator.get_state())
        assert second.model.training
    finally:
        second.close()


def test_train_cli_writes_a_checkpoint_and_an_export_that_compresses(tmp_path):
    config = tinyConfig(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", "train", str(config),
                           "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    export = Path(proc.stdout.strip().splitlines()[-1])
    assert export.exists() and export.name.startswith("export_") and export.name.endswith(".mcquic.npz")
    from mcquic_tpu_torch.train.saver import Saver
    checkpoint = Saver.probeResume(tmp_path / "saved")
    assert checkpoint == tmp_path / "saved" / "latest" / "saved.ckpt.npz"
    tree, meta = loadTree(checkpoint)
    assert int(tree["step"]) == 2 and meta["config"]["train"]["totalStep"] == 2
    assert (tmp_path / "saved" / "latest" / "best.ckpt.npz").exists()
    assert "codebook reassigned" in proc.stderr and "validation" in proc.stderr
    assert "skipping codebook reassignment on the terminal step" in proc.stderr
    from mcquic_tpu_torch.cli import main
    png = tmp_path / "pngs" / "0.png"
    assert main(["--device", "cpu", "--local", str(export), str(png), str(tmp_path / "o.mcq")]) == 0
    assert main(["--device", "cpu", "--local", str(export), str(tmp_path / "o.mcq"),
                 str(tmp_path / "o.png")]) == 0
    assert readPng(tmp_path / "o.png").shape == readPng(png).shape


def _jpegShard(path: Path, members):
    """A tar shard of (name, RGB image) members written as q95 JPEGs by the
    port's encoder, the JAX writer's member format."""
    import io
    import tarfile
    from mcquic_tpu_torch.data.jpeg import encodeJpeg
    with tarfile.open(path, "w:gz") as tf:
        for name, img in members:
            data = encodeJpeg(img, 95)
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_saver_rotates_locks_and_caps_its_history(tmp_path):
    """A second live Saver on one directory is refused; a new Saver rotates
    `latest/` away and resumes from it; at most maxItems rotations stay."""
    from mcquic_tpu_torch.train.saver import Saver
    first = Saver(tmp_path)
    with pytest.raises(RuntimeError, match="already owned"):
        Saver(tmp_path)
    first.save({"step": np.asarray(1, np.int32)}, {"config": {}})
    assert Saver.probeResume(tmp_path) == first.CkptPath
    first.close()
    second = Saver(tmp_path, maxItems=1)
    assert second.PreviousCkpt is not None and second.PreviousCkpt != second.CkptPath
    flat, meta = Saver.load(second.PreviousCkpt)
    assert int(flat["step"]) == 1 and "version" in meta
    assert Saver.probeResume(tmp_path) is None            # the new latest/ is empty
    second.save({"step": np.asarray(2, np.int32)})
    second.close()
    third = Saver(tmp_path, maxItems=1)
    assert int(Saver.load(third.PreviousCkpt)[0]["step"]) == 2
    assert len([d for d in tmp_path.iterdir() if d.is_dir() and d.name != "latest"]) == 1
    third.close()


# ------------------------------------------------------------------ v2 family

NEON = "{key: Neon, params: {channel: 8, k: 16, size: [16, 8, 4, 2, 2]}}"
WNIDS = ["n01440764", "n02099601"]


def _recipe(tmp: Path, name: str, model: str, trainSet: Path, hooks: str = "") -> Path:
    config = tmp / f"{name}.yaml"
    config.write_text(f"""model: {model}
train:
  totalStep: 2
  batchSize: 2
  epoch: 100
  valFreq: 2
  trainSet: {trainSet}
  valSet: {trainSet}
  saveDir: {tmp / name}
  target: MsSSIM
  optim: {{key: Adam, params: {{lr: 1.0e-4}}}}
  schdr:
    key: CosineAnnealingWarmupRestarts
    params: {{first_cycle_steps: 10, warmup_steps: 1, lrScaleRatio: 0.001}}
{hooks}  gpu: {{gpus: 1, vRam: -1, wantsMore: false}}
""")
    return config


def tinyNeonConfig(tmp: Path) -> Path:
    """Neon at channel 8, k 16, size [16, 8, 4, 2, 2] (256x256 input) on
    three PNG crops, the reassign hook every step."""
    pngs = tmp / "neon_pngs"
    pngs.mkdir(exist_ok=True)
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    for i in range(3):
        writePng(pngs / f"{i}.png", img[i * 100:i * 100 + 300, i * 90:i * 90 + 300])
    return _recipe(tmp, "neon", NEON, pngs,
                   "  hooks:\n    - {key: CodebookReassign, params: {freq: 1}}\n")


def tinyGenConfig(tmp: Path, loadFrom: Path) -> Path:
    """The generator of .claude/skills/verify/SKILL.md (hidden 32, depth 1,
    4 heads) over the tiny Neon, on two class folders of PNGs."""
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    for j, wnid in enumerate(WNIDS):
        folder = tmp / "classes" / wnid
        folder.mkdir(parents=True, exist_ok=True)
        for i in range(2):
            writePng(folder / f"{i}.png", img[j * 150 + i * 40:j * 150 + i * 40 + 260,
                                              i * 200:i * 200 + 300])
    model = ("{key: GeneratorV3SelfAttention, params: {channel: 8, k: 16, size: [16, 8, 4, 2, 2], "
             f"hiddenSize: 32, depth: 1, nHeads: 4, numClasses: 1000, loadFrom: {loadFrom}}}}}")
    return _recipe(tmp, "gen", model, tmp / "classes")


def _cli(*args):
    """The train CLI on two torch threads, so that it does not spin against
    the test workers."""
    import os
    proc = subprocess.run([sys.executable, "-m", "mcquic_tpu_torch", "train", *map(str, args),
                           "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return Path(proc.stdout.strip().splitlines()[-1])


def _oneDeviceMesh():
    from mcquic_tpu.parallel import makeMesh
    return makeMesh(devices=jax.devices()[:1])


def _shapes(path) -> dict:
    from mcquic_tpu_torch.utils.convert import readExport
    flat, _ = readExport(path)
    return {k: v.shape for k, v in flat.items() if not k.startswith("torch/")}
