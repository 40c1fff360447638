"""The slice as a user meets it: the WebP photo (PIL's default quality) and
the CMYK photo (quality 95) of the decoder fixtures go through the JAX
package's demo (`mcquic_tpu.demo.main`, which reads them through PIL) and
the port's CLI (`--device cpu --local` the tiny demo model), whose decoders
are its own. The two `.mcq` files are byte-identical, and each package's
coder reads the other's file to the same codes.
"""
from pathlib import Path

import numpy as np
import pytest

from mcquic_tpu_torch.cli import main
from mcquic_tpu_torch.container import File
from mcquic_tpu_torch.demo import loadModel

ROOT = Path(__file__).resolve().parent.parent
TINY = ROOT / "assets" / "tiny_demo_672919fb.mcquic.npz"
INPUTS = {"photo.webp": ROOT / "tests" / "golden" / "torch_webp" / "photo_q80.webp",
          "photo_cmyk.jpg": ROOT / "tests" / "golden" / "torch_jpeg" / "photo_cmyk_q95.jpg"}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """name -> (the JAX demo's .mcq bytes, the port CLI's)."""
    from mcquic_tpu.demo import main as jaxMain
    tmp = tmp_path_factory.mktemp("forms")
    out = {}
    for name, source in INPUTS.items():
        image = tmp / name
        image.write_bytes(source.read_bytes())
        jaxMain(qp=None, local=str(TINY), disable_gpu=True, mse=False, crop=False,
                inputPath=image, outputPath=tmp / f"{name}.jax.mcq")
        assert main(["--device", "cpu", "--local", str(TINY), str(image),
                     str(tmp / f"{name}.port.mcq")]) == 0
        out[name] = ((tmp / f"{name}.jax.mcq").read_bytes(), (tmp / f"{name}.port.mcq").read_bytes())
    return out


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_the_jax_demo_and_the_port_cli_write_the_same_mcq(written, name):
    jaxBytes, portBytes = written[name]
    assert portBytes == jaxBytes
    header = File.deserialize(portBytes).FileHeader
    assert (header.ImageSize.height, header.ImageSize.width) == (512, 768)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_each_package_reads_the_others_mcq_to_the_same_codes(written, name):
    from mcquic_tpu.container import File as JaxFile
    from mcquic_tpu.demo import loadModel as jaxLoadModel
    jaxBytes, portBytes = written[name]
    jaxFile, portFile = JaxFile.deserialize(portBytes), File.deserialize(jaxBytes)
    theirs = jaxLoadModel(local=str(TINY)).coder.decompress([jaxFile.Content],
                                                             [jaxFile.FileHeader.CodeSize])
    ours = loadModel(local=TINY, device="cpu").coder.decompress([portFile.Content],
                                                                [portFile.FileHeader.CodeSize])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
