"""`.mcq` files cross between the PyTorch port and the JAX package.

Both engines run the same weights in fp64 on the CPU (the JAX one under
`jax.enable_x64`) on a crop of assets/photo_768x512.png that needs
padding: the two files must be byte-identical, and each package must
restore the other's file to the same codes and the same image.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.container import File as JaxFile
from mcquic_tpu.models.compressor import Compressor as JaxCompressor
from mcquic_tpu.models.engine import CompressorEngine as JaxEngine
from mcquic_tpu_torch.container import File
from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.models.engine import CompressorEngine
from test_torch_weights import SMALL, jaxVariables, portModel, randomStateDict

PHOTO = Path(__file__).resolve().parent.parent / "assets" / "photo_768x512.png"


@pytest.fixture(scope="module")
def engines():
    stateDict = randomStateDict(**SMALL, seed=2)
    module = JaxCompressor(channel=SMALL["channel"], m=SMALL["m"], k=tuple(SMALL["k"]),
                           dtype=jnp.float64)
    with jax.enable_x64():
        jaxEngine = JaxEngine(module, jaxVariables(stateDict, **SMALL), qp="7")
    return jaxEngine, CompressorEngine(portModel(stateDict, **SMALL), qp="7", device="cpu")


@pytest.fixture(scope="module")
def image():
    return readPng(PHOTO)[200:296, 300:412]          # 96 x 112: padded to 128 x 128


@pytest.fixture(scope="module")
def files(engines, image):
    jaxEngine, engine = engines
    with jax.enable_x64():
        jaxBytes = jaxEngine.compressImage(image).serialize()
    return jaxBytes, engine.compressImage(image).serialize()


def test_mcq_bytes_are_identical(files):
    jaxBytes, portBytes = files
    assert portBytes == jaxBytes


def test_each_package_reads_the_others_file(engines, files):
    jaxEngine, engine = engines
    jaxBytes, portBytes = files
    jaxFile, portFile = JaxFile.deserialize(portBytes), File.deserialize(jaxBytes)
    assert portFile.FileHeader.QuantizationParameter == "7"
    assert (portFile.FileHeader.ImageSize.height, portFile.FileHeader.ImageSize.width) == (96, 112)
    theirCodes = jaxEngine.coder.decompress([jaxFile.Content], [jaxFile.FileHeader.CodeSize])
    ourCodes = engine.coder.decompress([portFile.Content], [portFile.FileHeader.CodeSize])
    for theirs, ours in zip(theirCodes, ourCodes):
        np.testing.assert_array_equal(ours, theirs)


def test_each_package_restores_the_others_file(engines, files, image):
    jaxEngine, engine = engines
    jaxBytes, portBytes = files
    with jax.enable_x64():
        theirs = jaxEngine.decompressImage(JaxFile.deserialize(portBytes))
    ours = engine.decompressImage(File.deserialize(jaxBytes))
    assert ours.shape == image.shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_codes_survive_the_round_trip(engines, image):
    _, engine = engines
    codes, binaries, headers = engine.compress(image[None])
    back = engine.coder.decompress(binaries, [h.CodeSize for h in headers])
    for a, b in zip(codes, back):
        np.testing.assert_array_equal(a, b)
    restored = engine.decompress(binaries, headers)
    assert restored.shape == (1, 96, 112, 3) and restored.dtype == np.float64


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    from mcquic_tpu_torch.utils import resolveDevice
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        CompressorEngine(portModel(randomStateDict(**SMALL), **SMALL))
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        resolveDevice("cuda")
    assert resolveDevice("cpu").type == "cpu"


@pytest.mark.parametrize("h,w", [(96, 112), (128, 256), (130, 70)])
def test_alignment_matches_the_jax_package(h, w):
    from mcquic_tpu.data import transforms as jaxTransforms
    from mcquic_tpu_torch.data import transforms
    x = np.random.default_rng(h).integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    padded = transforms.alignedPadding(x, 128)
    np.testing.assert_array_equal(padded, jaxTransforms.alignedPadding(x, 128))
    np.testing.assert_array_equal(transforms.centerCropTo(padded, h, w), x)
    np.testing.assert_array_equal(transforms.alignedCrop(x, 64), jaxTransforms.alignedCrop(x, 64))


def test_encode_takes_uint8_images_only(engines, image):
    """uint8 and float input both encode: float in [-1, 1] is uploaded as it
    is, uint8 is normalized on the device by the same arithmetic, so the
    codes are the same. Only [n, h, w, c] batches are taken."""
    from mcquic_tpu_torch.data.transforms import imageToModelInput
    _, engine = engines
    fromFloat = engine.encode(imageToModelInput(image[None]))
    for a, b in zip(fromFloat, engine.encode(image[None])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match=r"\[n, h, w, c\]"):
        engine.encode(image.astype(np.float32))


def floatBatch(n, h, w, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, h, w, 3)).astype(np.float32)


def test_float_input_codes_and_bytes_match_jax(engines):
    """Fault C1: the same float batch through both engines gives the same
    fp64 codes and the same `.mcq` bytes."""
    jaxEngine, engine = engines
    x = floatBatch(2, 96, 112, seed=3)
    with jax.enable_x64():
        jaxCodes, jaxBinaries, jaxHeaders = jaxEngine.compress(x)
    codes, binaries, headers = engine.compress(x)
    for ours, theirs in zip(codes, jaxCodes):
        np.testing.assert_array_equal(ours, theirs)
    for i in range(2):
        assert (File(headers[i], binaries[i]).serialize()
                == JaxFile(jaxHeaders[i], jaxBinaries[i]).serialize())


BATCHES = [(2, 96, 112), (2, 128, 128), (2, 64, 80)]     # one padded shape: one compile


def test_compress_many_matches_per_batch_compress_and_jax(engines):
    jaxEngine, engine = engines
    batches = [floatBatch(*shape, seed=i) for i, shape in enumerate(BATCHES)]
    many = engine.compressMany(batches)
    with jax.enable_x64():
        jaxMany = jaxEngine.compressMany(batches)
    assert len(many) == len(jaxMany) == len(BATCHES)
    for x, (binaries, headers), (jaxBinaries, jaxHeaders) in zip(batches, many, jaxMany):
        _, once, onceHeaders = engine.compress(x)
        assert binaries == once == jaxBinaries
        for h, o, j in zip(headers, onceHeaders, jaxHeaders):
            assert (File(h, [b"x"]).serialize() == File(o, [b"x"]).serialize()
                    == JaxFile(j, [b"x"]).serialize())


def test_decompress_many_matches_jax(engines):
    jaxEngine, engine = engines
    batches = [floatBatch(*shape, seed=10 + i) for i, shape in enumerate(BATCHES)]
    items = engine.compressMany(batches)
    restored = engine.decompressMany(items)
    with jax.enable_x64():
        jaxRestored = jaxEngine.decompressMany(items)
    for ours, theirs, shape in zip(restored, jaxRestored, BATCHES):
        assert ours.shape == theirs.shape == (*shape, 3)
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-8)
        binaries, headers = items[BATCHES.index(shape)]
        np.testing.assert_array_equal(ours, engine.decompress(binaries, headers))


def test_normalized_freq_matches_jax(engines):
    jaxEngine, engine = engines
    for ours, theirs in zip(engine.coder.NormalizedFreq, jaxEngine.coder.NormalizedFreq):
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_allclose(ours.sum(-1), 1.0, rtol=0, atol=1e-12)


def test_tiled_file_crosses_packages(engines, image):
    """A tiled `.mcq` written by either package is byte-identical and
    restores in the other to the same image."""
    from mcquic_tpu.models.tiling import TiledFile as JaxTiledFile
    from mcquic_tpu.models.tiling import compressTiled as jaxCompressTiled
    from mcquic_tpu.models.tiling import decompressTiled as jaxDecompressTiled
    from mcquic_tpu_torch.models.tiling import TiledFile, compressTiled, decompressTiled
    jaxEngine, engine = engines
    with jax.enable_x64():
        jaxBytes = jaxCompressTiled(jaxEngine, image, tile=64).serialize()
    portBytes = compressTiled(engine, image, tile=64).serialize()
    assert portBytes == jaxBytes
    assert TiledFile.isTiled(portBytes) and not TiledFile.isTiled(engine.compressImage(image).serialize())
    tf = TiledFile.deserialize(jaxBytes)
    assert (tf.rows, tf.cols, tf.tile, tf.height, tf.width, tf.qp) == (2, 2, 64, 96, 112, "7")
    ours = decompressTiled(engine, tf)
    with jax.enable_x64():
        theirs = jaxDecompressTiled(jaxEngine, JaxTiledFile.deserialize(portBytes))
    assert ours.shape == image.shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_rans_library_releases_the_gil():
    """compressMany runs rANS on a worker thread while the main thread
    launches the next batch: that overlaps only if the ctypes calls release
    the GIL, which a `CDLL` does and a `PyDLL` does not."""
    import ctypes
    from mcquic_tpu_torch.coding import rans
    lib = rans._library()
    assert type(lib) is ctypes.CDLL
    assert not lib.mcq_encode_batch._flags_ & ctypes._FUNCFLAG_PYTHONAPI
    assert not lib.mcq_decode_batch._flags_ & ctypes._FUNCFLAG_PYTHONAPI


# ----------------------------------------------------------------- Neon
NEON = dict(channel=8, k=16, size=[4, 2, 2])


@pytest.fixture(scope="module")
def neonEngines(tmp_path_factory):
    """A seeded Neon export written by the port (`demo.writeSeededExport`),
    loaded by both packages' `demo.loadModel`, the models cast to fp64."""
    from mcquic_tpu.demo import loadModel as jaxLoadModel
    from mcquic_tpu_torch.demo import loadModel, writeSeededExport
    path = writeSeededExport(tmp_path_factory.mktemp("neon") / "neon.npz", "Neon", NEON, seed=3,
                             qp="5")
    engine = loadModel(local=path, device="cpu")
    engine.model.double()
    theirs = jaxLoadModel(local=str(path))
    module = theirs._module.clone(dtype=jnp.float64)
    with jax.enable_x64():
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), theirs._variables)
        jaxEngine = JaxEngine(module, variables, qp="5")
    return jaxEngine, engine, path


def test_neon_engine_takes_m_1_and_k_per_level(neonEngines):
    _, engine, path = neonEngines
    from mcquic_tpu_torch.models.compressor import Neon
    from mcquic_tpu_torch.utils.convert import modelGeometry, readExport
    assert isinstance(engine.model, Neon)
    assert modelGeometry(readExport(path)[1]) == NEON
    assert (engine._m, engine._k) == ([1, 1, 1], [16, 16, 16])
    codes = engine.encode(floatBatch(1, 96, 112, seed=4))
    assert [c.shape for c in codes] == [(1, 1, 4, 4), (1, 1, 4, 4), (1, 1, 8, 8)]   # 128 / 32
    assert all(c.min() >= 0 and c.max() < NEON["k"] for c in codes)


def test_neon_mcq_crosses_packages_with_identical_codes(neonEngines, image):
    """fp64: the same image gives bit-identical codes and byte-identical
    `.mcq` files in both packages, and each restores the other's file to
    the same codes and image."""
    jaxEngine, engine, _ = neonEngines
    with jax.enable_x64():
        jaxCodes = jaxEngine.encode(image[None])
        jaxBytes = jaxEngine.compressImage(image).serialize()
    codes = engine.encode(image[None])
    for ours, theirs in zip(codes, jaxCodes):
        np.testing.assert_array_equal(ours, theirs)
    portBytes = engine.compressImage(image).serialize()
    assert portBytes == jaxBytes
    jaxFile, portFile = JaxFile.deserialize(portBytes), File.deserialize(jaxBytes)
    for ours, theirs in zip(engine.coder.decompress([portFile.Content], [portFile.FileHeader.CodeSize]),
                            jaxEngine.coder.decompress([jaxFile.Content], [jaxFile.FileHeader.CodeSize])):
        np.testing.assert_array_equal(ours, theirs)
    ours = engine.decompressImage(File.deserialize(jaxBytes))
    with jax.enable_x64():
        theirs = jaxEngine.decompressImage(JaxFile.deserialize(portBytes))
    assert ours.shape == image.shape and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_neon_export_round_trips_through_the_cli(neonEngines, tmp_path, image):
    from mcquic_tpu_torch.cli import main
    from mcquic_tpu_torch.data.png import writePng
    _, engine, path = neonEngines
    writePng(tmp_path / "in.png", image)
    assert main(["--device", "cpu", "--local", str(path), str(tmp_path / "in.png"),
                 str(tmp_path / "out.mcq")]) == 0
    assert main(["--device", "cpu", "--local", str(path), str(tmp_path / "out.mcq"),
                 str(tmp_path / "out.png")]) == 0
    assert readPng(tmp_path / "out.png").shape == image.shape
    assert File.deserialize((tmp_path / "out.mcq").read_bytes()).FileHeader.QuantizationParameter == "5"


def test_engine_leaves_a_training_module_as_it_was(engines, image):
    """A trainer validates its live model: the engine neither switches it to
    eval nor turns off its gradients."""
    model = portModel(randomStateDict(**SMALL, seed=2), **SMALL).train()
    before = [p.requires_grad for p in model.parameters()]
    engine = CompressorEngine(model, device="cpu")
    engine.decompressImage(engine.compressImage(image))
    assert model.training and all(m.training for m in model.modules())
    assert [p.requires_grad for p in model.parameters()] == before and any(before)
