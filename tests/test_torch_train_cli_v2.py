"""The port's `train` CLI for Neon and the generator, and what it refuses
and reads (the helpers are tests/test_torch_train_cli.py's):

  * Neon (`train CONFIG`, a `size` pyramid) and the generator over it
    (`train -G CONFIG`, `loadFrom` the Neon checkpoint) train through the
    CLI; their checkpoints hold the keys and shapes of the JAX trainers'
    checkpoints for the same configs; the port's Neon checkpoint loads in
    the JAX package's `loadCompressorParams` and resumes in its `Trainer`;
    a JAX `GenTrainer` checkpoint resumes in the port and the port's in the
    JAX `GenTrainer`; `generate` samples from the port's.
  * A generator the port lacks and a stage-2 config without -G are
    refused; tar shards train both stages; a folder holding a BMP and a
    WebP, and a progressive JPEG member with bits unsent, are read as the
    JAX loaders read them.
"""
import numpy as np
import pytest

from mcquic_tpu.train.saver import loadTree
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data.png import readPng, writePng
from mcquic_tpu_torch.train.trainer import Trainer
from test_torch_train_cli import (ROOT, WNIDS, _cli, _jpegShard, _oneDeviceMesh, _shapes,
                                  tinyConfig, tinyGenConfig, tinyNeonConfig)
from test_torch_weights import flattenTree


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    """Neon, then the generator over it, each 2 steps through the CLI."""
    tmp = tmp_path_factory.mktemp("v2")
    neonConfig = tinyNeonConfig(tmp)
    export = _cli(neonConfig)
    neonCkpt = tmp / "neon" / "latest" / "saved.ckpt.npz"
    genConfig = tinyGenConfig(tmp, neonCkpt)
    genCkpt = _cli("-G", genConfig)
    return tmp, neonConfig, export, neonCkpt, genConfig, genCkpt


def test_neon_checkpoint_is_the_jax_trainers_and_loads_there(v2, tmp_path):
    from mcquic_tpu.config import Config as JaxConfig
    from mcquic_tpu.train.genTrainer import loadCompressorParams
    from mcquic_tpu.train.trainer import Trainer as JaxTrainer
    _, neonConfig, export, neonCkpt, _, _ = v2
    assert export.name.startswith("export_") and export.exists()
    tree, meta = loadTree(neonCkpt)
    assert int(tree["step"]) == 2 and meta["config"]["model"]["key"] == "Neon"
    data = JaxConfig.load(str(neonConfig)).serialize()
    data["train"]["saveDir"] = str(tmp_path / "jax")
    jaxConfig = JaxConfig.deserialize(data)
    jaxTrainer = JaxTrainer(jaxConfig, lpipsFn=False, mesh=_oneDeviceMesh())
    jaxTrainer.save()
    jaxTrainer.close()
    jaxCkpt = tmp_path / "jax" / "latest" / "saved.ckpt.npz"
    assert _shapes(neonCkpt) == _shapes(jaxCkpt)
    # the JAX trainer's checkpoint resumes in the port, and is a tokenizer there
    from mcquic_tpu_torch.train.genTrainer import loadCompressorParams as portLoadCompressor
    from mcquic_tpu_torch.utils.convert import readExport
    theirs, _ = readExport(jaxCkpt)
    assert portLoadCompressor(jaxCkpt).keys() == {k for k in theirs
                                                   if k.startswith(("params/", "coder/"))}
    portTrainer = Trainer(Config.deserialize(data), device="cpu", lpipsFn=False)
    try:
        assert portTrainer.tryResume() and portTrainer.step == 0
        mine = portTrainer.checkpoint()
        for key, value in theirs.items():
            if key.startswith(("params/", "coder/", "optState/")):
                np.testing.assert_array_equal(mine[key], value, err_msg=key)
    finally:
        portTrainer.close()
    params, coder = loadCompressorParams(neonCkpt)
    flat = flattenTree({"params": params, "coder": coder})
    from mcquic_tpu_torch.utils.convert import readExport
    ours, _ = readExport(neonCkpt)
    for key, value in flat.items():
        np.testing.assert_array_equal(value, ours[key], err_msg=key)
    # the JAX trainer resumes the port's checkpoint
    import shutil
    resumeDir = tmp_path / "jaxResume" / "latest"
    resumeDir.mkdir(parents=True)
    shutil.copy(neonCkpt, resumeDir / "saved.ckpt.npz")
    shutil.copy(neonCkpt.with_suffix(".json"), resumeDir / "saved.ckpt.json")
    data["train"]["saveDir"] = str(tmp_path / "jaxResume")
    resumed = JaxTrainer(JaxConfig.deserialize(data), lpipsFn=False, mesh=_oneDeviceMesh())
    try:
        assert resumed.tryResume() and int(resumed.state.step) == 2
        np.testing.assert_array_equal(np.asarray(resumed.state.params["_quantizer"]["codebook"]),
                                      ours["params/_quantizer/codebook"])
    finally:
        resumed.close()


def test_gen_checkpoint_is_the_jax_gen_trainers_both_ways_and_samples(v2, tmp_path):
    from mcquic_tpu.config import Config as JaxConfig
    from mcquic_tpu.train.genTrainer import GenTrainer as JaxGenTrainer
    from mcquic_tpu_torch.train.genTrainer import GenTrainer
    from mcquic_tpu_torch.utils.convert import readExport
    tmp, _, _, neonCkpt, genConfig, genCkpt = v2
    ours, meta = readExport(genCkpt)
    assert int(ours["step"]) == 2 and meta["config"]["model"]["key"] == "GeneratorV3SelfAttention"
    neon, _ = readExport(neonCkpt)
    for key, value in neon.items():               # the tokenizer is the loaded one, untouched
        if key.startswith(("params/", "coder/")):
            np.testing.assert_array_equal(ours[key.replace("/", "/compressor/", 1)], value)
    data = JaxConfig.load(str(genConfig)).serialize()
    data["train"]["saveDir"] = str(tmp_path / "jax")
    jaxConfig = JaxConfig.deserialize(data)
    jaxTrainer = JaxGenTrainer(jaxConfig, mesh=_oneDeviceMesh())
    jaxTrainer.save()
    jaxTrainer.close()
    jaxCkpt = tmp_path / "jax" / "latest" / "saved.ckpt.npz"
    assert _shapes(genCkpt) == _shapes(jaxCkpt)
    # the JAX checkpoint resumes in the port
    trainer = GenTrainer(Config.deserialize(data), device="cpu")
    try:
        assert trainer.tryResume() and trainer.step == 0
        theirs, _ = readExport(trainer._resumePath)
        mine = trainer.checkpoint()
        for key, value in theirs.items():
            if key.startswith(("params/", "coder/", "optState/")):
                np.testing.assert_array_equal(mine[key], value, err_msg=key)
        assert trainer.trainStep(np.zeros((2, 256, 256, 3), np.uint8),
                                 np.array([0, 1]))["skipped"] == 0.0
    finally:
        trainer.close()
    # the port's checkpoint resumes in the JAX GenTrainer
    import shutil
    resumeDir = tmp_path / "jaxResume" / "latest"
    resumeDir.mkdir(parents=True)
    shutil.copy(genCkpt, resumeDir / "saved.ckpt.npz")
    shutil.copy(genCkpt.with_suffix(".json"), resumeDir / "saved.ckpt.json")
    data["train"]["saveDir"] = str(tmp_path / "jaxResume")
    resumed = JaxGenTrainer(JaxConfig.deserialize(data), mesh=_oneDeviceMesh())
    try:
        assert resumed.tryResume() and int(resumed.state.step) == 2
        np.testing.assert_array_equal(np.asarray(resumed.state.params["classEmbed"]),
                                      ours["params/classEmbed"])
    finally:
        resumed.close()
    from mcquic_tpu_torch.cli import main
    assert main(["generate", "-c", "1,207", "--device", "cpu", str(genCkpt),
                 str(tmp_path / "out")]) == 0
    assert readPng(tmp_path / "out" / "class207_1.png").shape == (256, 256, 3)


def test_train_cli_refuses_what_the_port_cannot_train(tmp_path, v2):
    """A generator the port lacks and a stage-2 config without -G are refused.
    Tar shards are read: stage 1 trains 2 steps from a `*.tar.gz` glob of
    `{key}.jpg` members (the JAX writer's layout) and stage 2 (`-G`) from
    wnid-keyed `{wnid}_{n}.jpg` shards over the tiny Neon. A training folder
    holding a BMP and a WebP gives the JAX loader's batches; a progressive
    JPEG member trains, and one whose scans leave bits unsent is read as the
    JAX `TarShards` reads it (libjpeg smooths its blocks)."""
    import io
    import tarfile
    from PIL import Image
    from mcquic_tpu.data import getTrainLoader as jaxGetTrainLoader
    from mcquic_tpu.data.dataset import TarShards as JaxTarShards
    from mcquic_tpu_torch.data import TarShards, getTrainLoader
    config = tinyConfig(tmp_path)
    text = config.read_text()
    var = tmp_path / "var.yaml"
    var.write_text(text.replace("{key: Compressor, params: {channel: 8, m: 2, k: [16, 8]}}",
                                "{key: GeneratorVAR, params: {channel: 8, k: 16, size: [2, 1, 1]}}"))
    unknown = tmp_path / "unknown.yaml"
    unknown.write_text(var.read_text().replace("GeneratorVAR", "GeneratorV2"))
    from mcquic_tpu_torch.train.cli import main
    from mcquic_tpu_torch.train.genTrainer import constructGenerator
    with pytest.raises(NotImplementedError, match="GeneratorV2"):
        main(unknown, gen=True, device="cpu")
    with pytest.raises(NotImplementedError, match="GeneratorV2"):
        constructGenerator("GeneratorV2", {})
    with pytest.raises(ValueError, match="-G/--gen"):
        main(var, device="cpu")

    img = readPng(ROOT / "assets" / "photo_768x512.png")
    (tmp_path / "shards").mkdir()
    for s in range(2):
        _jpegShard(tmp_path / "shards" / f"mcquic_DATA_{s:05d}.tar.gz",
                   [(f"{2 * s + i:09d}.jpg", img[i * 120:i * 120 + 256, s * 300:s * 300 + 300])
                    for i in range(2)])
    shards = tmp_path / "shards.yaml"
    shards.write_text(text.replace(f"trainSet: {tmp_path / 'pngs'}",
                                   f"trainSet: {tmp_path / 'shards'}/*.tar.gz"))
    export = main(shards, device="cpu")
    assert export.exists()
    tree, _ = loadTree(tmp_path / "saved" / "latest" / "saved.ckpt.npz")
    assert int(tree["step"]) == 2

    _, _, _, neonCkpt, genConfig, _ = v2
    (tmp_path / "genShards").mkdir()
    _jpegShard(tmp_path / "genShards" / "gen.tar.gz",
               [(f"{WNIDS[i % 2]}_{i}.jpg", img[i * 60:i * 60 + 260, i * 90:i * 90 + 300])
                for i in range(4)])
    genShards = tmp_path / "genShards.yaml"
    genShards.write_text(genConfig.read_text()
                         .replace(f"trainSet: {genConfig.parent / 'classes'}",
                                  f"trainSet: {tmp_path / 'genShards'}/*.tar.gz")
                         .replace(f"saveDir: {genConfig.parent / 'gen'}",
                                  f"saveDir: {tmp_path / 'gen'}"))
    checkpoint = main(genShards, gen=True, device="cpu")
    assert int(loadTree(checkpoint)[0]["step"]) == 2

    (tmp_path / "bmp").mkdir()
    writePng(tmp_path / "bmp" / "a.png", img[:256, :256])
    Image.fromarray(np.ascontiguousarray(img[256:, :256])).save(tmp_path / "bmp" / "b.bmp")
    Image.fromarray(np.ascontiguousarray(img[100:356, 400:700])).save(tmp_path / "bmp" / "c.webp")
    ours = list(getTrainLoader(tmp_path / "bmp", 3, cropSize=64, seed=2)())
    theirs = list(jaxGetTrainLoader(str(tmp_path / "bmp"), 3, cropSize=64, seed=2)())
    assert len(ours) == len(theirs) == 1
    gap = np.abs(ours[0].astype(int) - theirs[0].astype(int))
    assert gap.max() <= 1 and (gap > 0).mean() < 0.25

    progressive = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[:256, :300])).save(progressive, format="JPEG",
                                                                progressive=True)

    def member(data):
        with tarfile.open(tmp_path / "shards" / "mcquic_DATA_00002.tar", "w") as tf:
            info = tarfile.TarInfo("000000009.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    member(progressive.getvalue())
    mixed = tmp_path / "mixed.yaml"
    mixed.write_text(text.replace(f"trainSet: {tmp_path / 'pngs'}",
                                  f"trainSet: {tmp_path / 'shards'}/*.tar*")
                     .replace(f"saveDir: {tmp_path / 'saved'}", f"saveDir: {tmp_path / 'mixed'}"))
    assert main(mixed, device="cpu").exists()
    data = progressive.getvalue()
    member(data[:data.rindex(b"\xff\xda")] + b"\xff\xd9")
    shard = str(tmp_path / "shards" / "mcquic_DATA_00002.tar")
    (ours,), (theirs,) = list(TarShards(shard)), list(JaxTarShards(shard))
    np.testing.assert_array_equal(ours, theirs)
