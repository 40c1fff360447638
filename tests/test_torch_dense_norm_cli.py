"""A denseNorm Neon through the port's entry points on the CPU: `train
CONFIG` for 2 steps, its export through the codec CLI (`--local`, a `.mcq`
and back), then `train -G` over a denseNorm Neon checkpoint and `generate`
from the generator it writes.

Channel 32: flax's and torch's GroupNorm need the 32 groups the Neon's wide
stages take to divide the channel. The stage-1 Neon is k 16, size [2, 1,
1] (32x32 crops, batch 2); the generator's tokenizer is a seeded denseNorm
Neon export (`demo.writeSeededExport`) at size [16, 8, 4, 2, 2], the grid
the stage-2 loader's 256x256 crops give, under tests/test_torch_train_cli.py's
tiny generator (hidden 32, depth 1, 4 heads). The numerics are held to the
JAX package's in tests/test_torch_dense_norm.py; here the paths run and keep
the flag, with the GroupNorm leaves under the JAX trainer's names.
"""
import numpy as np

from mcquic_tpu.train.saver import loadTree
from mcquic_tpu_torch.cli import main as cli
from mcquic_tpu_torch.data.png import readPng, writePng
from mcquic_tpu_torch.demo import writeSeededExport
from test_torch_train_cli import ROOT, _cli, _recipe, tinyGenConfig

NEON_DN = "{key: Neon, params: {channel: 32, k: 16, size: [2, 1, 1], denseNorm: true}}"


def test_dense_norm_neon_trains_and_codes(tmp_path):
    pngs = tmp_path / "pngs"
    pngs.mkdir()
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    for i in range(2):
        writePng(pngs / f"{i}.png", img[i * 100:i * 100 + 96, i * 90:i * 90 + 96])
    export = _cli(_recipe(tmp_path, "neon", NEON_DN, pngs))
    tree, meta = loadTree(tmp_path / "neon" / "latest" / "saved.ckpt.npz")
    assert int(tree["step"]) == 2 and meta["config"]["model"]["params"]["denseNorm"] is True
    norm = tree["params"]["_encoder"]["ResidualBlock_0"]["GroupNorm_0"]
    assert norm["scale"].shape == norm["bias"].shape == (32,)
    assert not np.array_equal(norm["scale"], np.ones(32))          # trained from one
    mcq, restored = tmp_path / "a.mcq", tmp_path / "a.png"
    assert cli(["--device", "cpu", "--local", str(export), str(pngs / "0.png"), str(mcq)]) == 0
    assert cli(["--device", "cpu", "--local", str(export), str(mcq), str(restored)]) == 0
    assert readPng(restored).shape == (96, 96, 3)


def test_a_generator_trains_over_a_dense_norm_neon_and_samples(tmp_path):
    geometry = dict(channel=32, k=16, size=[16, 8, 4, 2, 2], denseNorm=True)
    neon = writeSeededExport(tmp_path / "neon.mcquic.npz", "Neon", geometry)
    genConfig = tinyGenConfig(tmp_path, neon)
    genConfig.write_text(genConfig.read_text().replace(
        "{channel: 8, k: 16, size: [16, 8, 4, 2, 2],",
        "{channel: 32, k: 16, size: [16, 8, 4, 2, 2], denseNorm: true,"))
    genCkpt = _cli("-G", genConfig)
    genTree, _ = loadTree(genCkpt)
    frozen = genTree["params"]["compressor"]["_encoder"]["ResidualBlock_0"]["GroupNorm_0"]["scale"]
    seeded, _ = loadTree(neon)
    np.testing.assert_array_equal(frozen, seeded["params"]["_encoder"]["ResidualBlock_0"]
                                  ["GroupNorm_0"]["scale"])        # the frozen tokenizer's
    assert cli(["generate", "-c", "1,207", "--device", "cpu", str(genCkpt),
                str(tmp_path / "out")]) == 0
    assert len(list((tmp_path / "out").glob("*.png"))) == 2
