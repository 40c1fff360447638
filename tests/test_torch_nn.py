"""Per-block parity of the PyTorch port's nn layer with the JAX package, fp64.

Each case makes a block's weights in the reference names from a numpy seed,
builds the flax tree with the JAX package's name map
(`mcquic_tpu/utils/convert.py::_Map`), takes it back into the port through
the port's inverse map (`mcquic_tpu_torch/utils/convert.py::_Map`, the one
`fromJaxParams` uses), and runs the same NHWC input through both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu import nn as jnn
from mcquic_tpu.nn.functional import pixelShuffle as jaxPixelShuffle
from mcquic_tpu.nn.functional import pixelUnshuffle as jaxPixelUnshuffle
from mcquic_tpu.utils.convert import _Map as JaxMap
from mcquic_tpu_torch import nn as tnn
from mcquic_tpu_torch.nn.functional import pixelShuffle, pixelUnshuffle
from mcquic_tpu_torch.utils.convert import _Map as PortMap
from test_torch_weights import flattenTree, randomValue

F64 = jnp.float64
# JAX's GenDivNorm casts its normalizer to fp32 even when it computes in fp64
# (mcquic_tpu/nn/gdn.py: `std.astype(jnp.float32) + beta`), so a bare GDN on
# unit-scale input agrees with it only to fp32 rounding of the normalizer
# (2^-24 relative, times |y|: about 3e-8 here); test_gdn_is_exact_in_fp64
# holds the port's GDN to an fp64 formula at 1e-12 instead.
GDN_RTOL = 2 ** -23
ATOL = 1e-8


def _setPath(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def runBlock(jaxModule, portModule, fill, xShape, seed=0):
    """fill(jaxMap, portMap) names the block in both maps under prefix `b`.
    Returns (jax out, port out) as NHWC fp64 arrays."""
    rng = np.random.default_rng(seed)
    stateDict = {key: randomValue(key, tuple(v.shape), rng)
                 for key, v in portModule.state_dict().items()}
    jaxMap, portMap = JaxMap(), PortMap()
    fill(jaxMap, portMap)
    tree = {}
    for path, (torchKey, fn) in jaxMap.entries.items():
        _setPath(tree, path, fn(stateDict[torchKey[2:]]))
    flat = flattenTree(tree)
    back = {torchKey[2:]: fn(flat[flaxKey]) for torchKey, (flaxKey, fn) in portMap.entries.items()}
    assert set(back) == set(stateDict)
    for key, value in stateDict.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    portModule = portModule.double().eval()
    portModule.load_state_dict({key: torch.from_numpy(np.array(v)) for key, v in back.items()})
    x = rng.normal(size=xShape)
    with jax.enable_x64():
        want = np.asarray(jax.jit(jaxModule.apply)(tree, x))
    with torch.no_grad():
        got = portModule(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    return want, got


C = 16


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3(stride):
    want, got = runBlock(jnn.conv3x3(C, stride=stride, dtype=F64), tnn.conv3x3(C, C, stride),
                         lambda j, p: (j.conv(("params",), "b"), p.conv("b", ("params",))),
                         (2, 12, 10, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_conv1x1():
    want, got = runBlock(jnn.conv1x1(C, dtype=F64), tnn.conv1x1(C, C),
                         lambda j, p: (j.conv(("params",), "b"), p.conv("b", ("params",))),
                         (1, 8, 8, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn(inverse):
    jaxModule = (jnn.InvGenDivNorm if inverse else jnn.GenDivNorm)(dtype=F64)
    portModule = tnn.InvGenDivNorm(C) if inverse else tnn.GenDivNorm(C)
    want, got = runBlock(jaxModule, portModule,
                         lambda j, p: (j.gdn(("params",), "b"), p.gdn("b", ("params",))),
                         (2, 6, 7, C))
    np.testing.assert_allclose(got, want, rtol=GDN_RTOL, atol=ATOL)


def test_gdn_is_exact_in_fp64():
    rng = np.random.default_rng(3)
    gdn = tnn.GenDivNorm(C).double()
    with torch.no_grad():
        gdn.beta.copy_(torch.from_numpy(randomValue("beta", (C,), rng)))
        gdn.gamma.copy_(torch.from_numpy(randomValue("gamma", (C, C), rng)))
        x = rng.normal(size=(2, C, 5, 4))
        got = gdn(torch.from_numpy(x)).numpy()
    eps2 = 1e-12
    beta = np.maximum(gdn.beta.detach().numpy(), np.sqrt(1e-4 + eps2)) ** 2 - eps2
    gamma = np.maximum(gdn.gamma.detach().numpy(), np.sqrt(eps2)) ** 2 - eps2
    std = np.einsum("oi,nihw->nohw", gamma, x * x) + beta[None, :, None, None]
    np.testing.assert_allclose(got, x / np.sqrt(std), rtol=0, atol=1e-12)


def test_residual_block():
    want, got = runBlock(jnn.ResidualBlock(C, dtype=F64), tnn.ResidualBlock(C),
                         lambda j, p: (j.residualBlock(("params",), "b"),
                                       p.residualBlock("b", ("params",))),
                         (2, 8, 6, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_residual_block_with_stride():
    want, got = runBlock(jnn.ResidualBlockWithStride(C, 2, dtype=F64),
                         tnn.ResidualBlockWithStride(C, 2),
                         lambda j, p: (j.residualBlockStride(("params",), "b"),
                                       p.residualBlockStride("b", ("params",))),
                         (2, 8, 12, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_residual_block_shuffle():
    want, got = runBlock(jnn.ResidualBlockShuffle(C, 2, dtype=F64), tnn.ResidualBlockShuffle(C, 2),
                         lambda j, p: (j.residualBlockShuffle(("params",), "b"),
                                       p.residualBlockShuffle("b", ("params",))),
                         (1, 5, 6, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("form,outC", [("plain", 2 * C), ("plain", C // 2), ("stride2", 2 * C),
                                       ("stride1", C // 2), ("shuffle", 2 * C)])
def test_channel_changing_blocks(form, outC):
    """The forms Neon's encoder, decoder and quantizer stacks use: a conv1x1
    skip (ResidualBlock, stride-1 ResidualBlockWithStride), a strided conv3x3
    skip, a pixelShuffle3x3 skip."""
    jaxBlock, portBlock, fill = {
        "plain": (jnn.ResidualBlock(outC, dtype=F64), tnn.ResidualBlock(C, outC),
                  lambda j, p: (j.residualBlock(("params",), "b", skip=True),
                                p.residualBlock("b", ("params",), skip=True))),
        "stride2": (jnn.ResidualBlockWithStride(outC, 2, dtype=F64),
                    tnn.ResidualBlockWithStride(C, 2, outC),
                    lambda j, p: (j.residualBlockStride(("params",), "b"),
                                  p.residualBlockStride("b", ("params",)))),
        "stride1": (jnn.ResidualBlockWithStride(outC, 1, dtype=F64),
                    tnn.ResidualBlockWithStride(C, 1, outC),
                    lambda j, p: (j.residualBlockStride(("params",), "b"),
                                  p.residualBlockStride("b", ("params",)))),
        "shuffle": (jnn.ResidualBlockShuffle(outC, 2, dtype=F64), tnn.ResidualBlockShuffle(C, 2, outC),
                    lambda j, p: (j.residualBlockShuffle(("params",), "b"),
                                  p.residualBlockShuffle("b", ("params",)))),
    }[form]
    want, got = runBlock(jaxBlock, portBlock, fill, (2, 8, 6, C))
    assert got.shape[-1] == outC
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_attention_block():
    want, got = runBlock(jnn.AttentionBlock(dtype=F64), tnn.AttentionBlock(C),
                         lambda j, p: (j.attentionBlock(("params",), "b"),
                                       p.attentionBlock("b", ("params",))),
                         (1, 8, 8, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("features", [3, C])
def test_pixel_shuffle_conv(features):
    """The decoder's thin RGB head (features 3: the K2 wrapper's CPU path)
    and a wide up-conv (plain conv + shuffle)."""
    want, got = runBlock(jnn.pixelShuffle3x3(features, rate=2, dtype=F64),
                         tnn.pixelShuffle3x3(C, features, 2),
                         lambda j, p: (j.conv(("params",), "b.0"), p.conv("b.0", ("params",))),
                         (2, 6, 5, C))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_pixel_shuffle_functions_match_the_nhwc_forms():
    x = np.random.default_rng(4).normal(size=(2, 5, 3, 12)).astype(np.float32)
    want = np.asarray(jaxPixelShuffle(jnp.asarray(x), 2))
    got = pixelShuffle(torch.from_numpy(x.transpose(0, 3, 1, 2)), 2).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)
    back = pixelUnshuffle(torch.from_numpy(want.transpose(0, 3, 1, 2).copy()), 2).numpy()
    np.testing.assert_array_equal(back.transpose(0, 2, 3, 1),
                                  np.asarray(jaxPixelUnshuffle(jnp.asarray(want), 2)))
    np.testing.assert_array_equal(back.transpose(0, 2, 3, 1), x)
