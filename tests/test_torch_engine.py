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
    _, engine = engines
    with pytest.raises(TypeError, match="uint8"):
        engine.encode(image[None].astype(np.float32))
