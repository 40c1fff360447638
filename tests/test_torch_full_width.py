"""The port against the JAX package at full width (ROADMAP C5), fp64 on the
CPU, with the same inputs through both packages.

* The qp-2 zoo model (`assets/zoo/qp_2_msssim_ec233f2c.mcquic.npz`: channel
  128, m 2, k [8192, 2048, 512]), loaded by each package's own loader, on a
  256x256 crop of assets/photo_768x512.png: the codes of all three levels
  bit-identical, the decode of those codes within 1e-8 (as
  tests/test_torch_compressor.py holds it at channel 16) and the `.mcq`
  bytes equal.

Neon at neon_v2_60k's geometry is tests/test_torch_full_width_neon.py, and
gen_stage2_neonA at full width and depth
tests/test_torch_generator.py::test_gen_stage2_neonA_geometry_matches.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.config import Config
from mcquic_tpu.demo import _buildModule
from mcquic_tpu.models.engine import CompressorEngine as JaxEngine
from mcquic_tpu.train.saver import loadTree, upcastBf16
from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.models.compressor import buildModel
from mcquic_tpu_torch.models.engine import CompressorEngine
from mcquic_tpu_torch.utils.convert import loadZoo, modelGeometry

ROOT = Path(__file__).resolve().parent.parent
QP2 = ROOT / "assets" / "zoo" / "qp_2_msssim_ec233f2c.mcquic.npz"
PHOTO = ROOT / "assets" / "photo_768x512.png"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def qp2():
    """(JAX module, its fp64 variables, the JAX engine, the port's fp64 model,
    the port's engine), each package through its own zoo loader."""
    tree, meta = loadTree(QP2)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64)
                                  if np.issubdtype(np.asarray(a).dtype, np.floating) else a,
                                  upcastBf16(tree))
    module = _buildModule(Config.deserialize(meta["config"])).clone(dtype=jnp.float64)
    variables = {"params": tree["params"], "coder": tree.get("coder", {})}
    with jax.enable_x64():
        jaxEngine = JaxEngine(module, variables, qp=str(meta["qp"]))
    stateDict, portMeta = loadZoo(QP2)
    model = buildModel(modelGeometry(portMeta))
    model.load_state_dict(stateDict, strict=True)
    model = model.double().eval().requires_grad_(False)
    return module, variables, jaxEngine, model, CompressorEngine(model, qp=str(portMeta["qp"]),
                                                                 device="cpu")


@pytest.fixture(scope="module")
def crop():
    return readPng(PHOTO)[128:384, 256:512]


@pytest.fixture(scope="module")
def qp2Codes(qp2, crop):
    module, variables, _, model, _ = qp2
    x = crop[None].astype(np.float64) / 127.5 - 1.0
    with jax.enable_x64():
        theirs = jax.jit(lambda v, x: module.apply(v, x, method="encode"))(variables, x)
        theirs = [np.asarray(c).transpose(0, 3, 1, 2) for c in theirs]
    with torch.no_grad():
        ours = [c.numpy() for c in model.encode(_nchw(x))]
    return ours, theirs


def test_qp2_codes_are_bit_identical(qp2Codes):
    ours, theirs = qp2Codes
    assert [c.shape for c in ours] == [(1, 2, 16, 16), (1, 2, 8, 8), (1, 2, 4, 4)]
    assert sum(c.size for c in ours) == 672
    for level, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(a, b, err_msg=f"level {level}")


def test_qp2_decode_agrees_within_1e8(qp2, qp2Codes):
    module, variables, _, model, _ = qp2
    _, theirs = qp2Codes
    jaxCodes = [c.transpose(0, 2, 3, 1) for c in theirs]
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, c: module.apply(v, c, method="decode"))(
            variables, jaxCodes))
    with torch.no_grad():
        got = model.decode([torch.from_numpy(c.copy()) for c in theirs]).numpy()
    got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 256, 256, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_qp2_mcq_bytes_are_equal(qp2, crop):
    _, _, jaxEngine, _, engine = qp2
    with jax.enable_x64():
        theirs = jaxEngine.compressImage(crop).serialize()
    assert engine.compressImage(crop).serialize() == theirs

