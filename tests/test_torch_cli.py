"""The port's CLI options `--crop`, `--tile` and `-qp 1`, on the CPU, against
the JAX package: a tiled `.mcq` the port writes is read by the JAX package's
`TiledFile` and restored by its `decompressTiled` to the port's pixels; the
qp-1 zoo model's `.mcq` decodes in the JAX package's coder to the port's
codes."""
from pathlib import Path

import numpy as np

from mcquic_tpu_torch.cli import main
from mcquic_tpu_torch.container import File
from mcquic_tpu_torch.data.png import readPng, writePng
from mcquic_tpu_torch.data.transforms import alignedCrop
from mcquic_tpu_torch.models.tiling import TiledFile, fromTiles, toTiles

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "assets" / "tiny_demo_672919fb.mcquic.npz"
PHOTO = ROOT / "assets" / "photo_768x512.png"


def _run(*args):
    assert main(["--device", "cpu", *map(str, args)]) == 0


def test_tile_round_trip_restores_in_the_jax_package(tmp_path, capsys):
    from mcquic_tpu.demo import loadModel
    from mcquic_tpu.models.tiling import TiledFile as JaxTiledFile
    from mcquic_tpu.models.tiling import decompressTiled as jaxDecompressTiled
    image = readPng(PHOTO)[100:300, 250:410]                      # 200 x 160
    writePng(tmp_path / "in.png", image)
    _run("--local", TINY, "--tile", 128, tmp_path / "in.png", tmp_path / "out.mcq")
    _run("--local", TINY, tmp_path / "out.mcq", tmp_path / "out.png")
    data = (tmp_path / "out.mcq").read_bytes()
    assert TiledFile.isTiled(data) and JaxTiledFile.isTiled(data)
    tf = TiledFile.deserialize(data)
    assert (tf.rows, tf.cols, tf.tile, tf.height, tf.width, tf.qp) == (2, 2, 128, 200, 160, "tiny")
    restored = readPng(tmp_path / "out.png")
    assert restored.shape == image.shape
    np.testing.assert_array_equal(
        restored, jaxDecompressTiled(loadModel(local=str(TINY)), JaxTiledFile.deserialize(data)))


def test_tiles_reassemble():
    image = np.random.default_rng(0).integers(0, 256, size=(70, 45, 3), dtype=np.uint8)
    tiles, rows, cols = toTiles(image, 32)
    assert tiles.shape == (rows * cols, 32, 32, 3) and (rows, cols) == (3, 2)
    np.testing.assert_array_equal(fromTiles(tiles, rows, cols, 70, 45), image)


def test_crop_codes_the_aligned_crop(tmp_path):
    image = readPng(PHOTO)[:200, :300]
    writePng(tmp_path / "in.png", image)
    writePng(tmp_path / "crop.png", alignedCrop(image, 128))
    _run("--local", TINY, "--crop", tmp_path / "in.png", tmp_path / "a.mcq")
    _run("--local", TINY, tmp_path / "crop.png", tmp_path / "b.mcq")
    file = File.deserialize((tmp_path / "a.mcq").read_bytes())
    size = file.FileHeader.ImageSize
    assert (size.height, size.width) == (128, 256)
    assert (tmp_path / "a.mcq").read_bytes() == (tmp_path / "b.mcq").read_bytes()


def test_qp1_zoo_model_through_the_port(tmp_path):
    """The second zoo slot, qp-1 (channel 128, m 2, k [512, 128, 32]): the
    port's `.mcq` decodes in the JAX package's coder to the port's codes."""
    from mcquic_tpu.coding import RansCoder as JaxCoder
    from mcquic_tpu.container import File as JaxFile
    from mcquic_tpu_torch.coding import RansCoder
    from mcquic_tpu_torch.demo import zooPath
    from mcquic_tpu_torch.utils.convert import readExport
    image = readPng(PHOTO)[192:320, 320:448]
    writePng(tmp_path / "in.png", image)
    _run("-qp", 1, tmp_path / "in.png", tmp_path / "out.mcq")
    _run(tmp_path / "out.mcq", tmp_path / "out.png")               # qp from the header
    assert readPng(tmp_path / "out.png").shape == image.shape
    data = (tmp_path / "out.mcq").read_bytes()
    jaxFile, file = JaxFile.deserialize(data), File.deserialize(data)
    assert jaxFile.FileHeader.QuantizationParameter == "1"
    assert file.FileHeader.CodeSize.k == [512, 128, 32]
    flat, _ = readExport(zooPath(1))
    freqs = [flat[f"coder/_quantizer/freqEMA{i}"] for i in range(3)]
    coder, jaxCoder = RansCoder([2] * 3, [512, 128, 32]), JaxCoder([2] * 3, [512, 128, 32])
    coder.updateFreq(freqs)
    jaxCoder.updateFreq(freqs)
    ours = coder.decompress([file.Content], [file.FileHeader.CodeSize])
    theirs = jaxCoder.decompress([jaxFile.Content], [jaxFile.FileHeader.CodeSize])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
