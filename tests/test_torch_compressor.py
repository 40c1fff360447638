"""The port's v1 Compressor against the JAX package's, fp64, small geometry
(channel 16, m 2, k [64, 32, 16]): encode codes bit-identical, decode of
the same codes within 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.models.compressor import Compressor as JaxCompressor
from test_torch_weights import SMALL, jaxVariables, portModel, randomStateDict


@pytest.fixture(scope="module")
def pair():
    stateDict = randomStateDict(**SMALL, seed=1)
    module = JaxCompressor(channel=SMALL["channel"], m=SMALL["m"], k=tuple(SMALL["k"]),
                           dtype=jnp.float64)
    return module, jaxVariables(stateDict, **SMALL), portModel(stateDict, **SMALL)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).uniform(-1, 1, size=(2, 128, 128, 3))


@pytest.fixture(scope="module")
def jaxCodes(pair, images):
    module, variables, _ = pair
    with jax.enable_x64():
        codes = jax.jit(lambda v, x: module.apply(v, x, method="encode"))(variables, images)
        return [np.asarray(c) for c in codes]


def test_encode_codes_are_bit_identical(pair, images, jaxCodes):
    _, _, model = pair
    with torch.no_grad():
        codes = model.encode(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()))
    assert [tuple(c.shape) for c in codes] == [(2, 2, 8, 8), (2, 2, 4, 4), (2, 2, 2, 2)]
    for level, (ours, theirs) in enumerate(zip(codes, jaxCodes)):
        np.testing.assert_array_equal(ours.numpy(), theirs.transpose(0, 3, 1, 2),
                                      err_msg=f"level {level}")


def test_decode_agrees_within_1e8(pair, jaxCodes):
    module, variables, model = pair
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, c: module.apply(v, c, method="decode"))(
            variables, jaxCodes))
    with torch.no_grad():
        got = model.decode([torch.from_numpy(c.transpose(0, 3, 1, 2).copy()) for c in jaxCodes])
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
