"""The port's two kernel modules on the CPU, against the JAX package.

K1 (ops/vq_cuda.py::vqNearest) and K2 (ops/subpixel_cuda.py::
conv3x3SubpixelThin) run their plain versions for CPU tensors; those are
held to the JAX package's functions and to its Pallas kernels in interpret
mode. The kernels themselves run only on a CUDA card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.ops.subpixel_pallas import conv3x3SubpixelThin as jaxThinHead
from mcquic_tpu.ops.vq import vqDequantizeCodes as jaxDequantize
from mcquic_tpu.ops.vq import vqEncode as jaxVqEncode
from mcquic_tpu.ops.vq import vqEncodeChunked as jaxVqEncodeChunked
from mcquic_tpu.ops.vq_pallas import residentFits as jaxResidentFits
from mcquic_tpu.ops.vq_pallas import vqEncodeFused, vqEncodeGrouped
from mcquic_tpu_torch.ops.subpixel_cuda import (conv3x3SubpixelPlain, conv3x3SubpixelThin,
                                                thinHeadSupported)
from mcquic_tpu_torch.ops import vq_cuda, vq_grouped_cuda
from mcquic_tpu_torch.ops.vq import (groupLatent, latentTokens, residentFits, ungroupLatent,
                                     vqDequantizeCodes, vqEncode, vqEncodePlain)
from mcquic_tpu_torch.ops.vq_cuda import splitPlan, vqNearest
from mcquic_tpu_torch.ops.vq_grouped_cuda import codewordNorms, vqNearestGrouped


def _nhwmd(n, h, w, m, d, rng, integer=False):
    if integer:   # small integers: every distance is exact, so ties are exact
        return rng.integers(-2, 3, size=(n, h, w, m, d)).astype(np.float32)
    return rng.normal(size=(n, h, w, m, d)).astype(np.float32)


def _portCodes(x, codebook):
    """JAX layout in ([n,h,w,m,d], [m,k,d]) -> port codes back in [n,h,w,m]."""
    xPort = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 4, 1, 2)))
    return vqEncode(xPort, torch.from_numpy(codebook)).numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("n,h,w,m,d,k,integer", [
    (2, 4, 6, 2, 8, 64, False),
    (1, 8, 8, 2, 8, 200, True),      # exact ties everywhere, k not a tile multiple
    (1, 6, 5, 1, 3, 7, True),
    (2, 3, 3, 3, 5, 130, False),
])
def test_vq_encode_matches_jax_and_pallas(n, h, w, m, d, k, integer):
    rng = np.random.default_rng(k)
    x = _nhwmd(n, h, w, m, d, rng, integer)
    codebook = (rng.integers(-2, 3, size=(m, k, d)) if integer
                else rng.normal(size=(m, k, d))).astype(np.float32)
    codebook[:, k // 2:k // 2 + k // 4] = codebook[:, :k // 4]      # duplicate codewords
    got = _portCodes(x, codebook)
    want = np.asarray(jaxVqEncode(jnp.asarray(x), jnp.asarray(codebook)))
    fused = np.asarray(vqEncodeFused(jnp.asarray(x), jnp.asarray(codebook), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fused)
    if integer:   # ties really happened, and went to the lowest index
        tokens = x.reshape(-1, m, d).transpose(1, 0, 2)
        dist = (codebook ** 2).sum(-1)[:, None, :] - 2 * np.einsum("mtd,mkd->mtk", tokens, codebook)
        assert ((dist == dist.min(-1, keepdims=True)).sum(-1) > 1).any()
        np.testing.assert_array_equal(got.reshape(-1, m).T, dist.argmin(-1))


def test_vq_encode_chunked_matches_jax_chunked():
    rng = np.random.default_rng(1)
    x = _nhwmd(1, 16, 16, 2, 16, rng)
    codebook = rng.normal(size=(2, 3000, 16)).astype(np.float32)
    want = np.asarray(jaxVqEncodeChunked(jnp.asarray(x), jnp.asarray(codebook)))
    np.testing.assert_array_equal(_portCodes(x, codebook), want)
    tokens = latentTokens(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 4, 1, 2))))
    whole = vqEncodePlain(tokens, torch.from_numpy(codebook), chunk=4096)
    for chunk in (1, 7, 1024):
        np.testing.assert_array_equal(vqEncodePlain(tokens, torch.from_numpy(codebook), chunk), whole)


def test_dequantize_and_grouping_match_jax():
    rng = np.random.default_rng(2)
    m, k, d = 2, 50, 8
    codebook = rng.normal(size=(m, k, d))
    codes = rng.integers(0, k, size=(2, 3, 4, m))
    want = np.asarray(jaxDequantize(jnp.asarray(codes), jnp.asarray(codebook, jnp.float32)))
    got = vqDequantizeCodes(torch.from_numpy(codes.transpose(0, 3, 1, 2).copy()),
                            torch.from_numpy(codebook.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    latent = torch.from_numpy(rng.normal(size=(2, m * d, 3, 4)))
    assert torch.equal(ungroupLatent(groupLatent(latent, m)), latent)
    assert torch.equal(groupLatent(latent, m)[:, 1], latent[:, d:])


def test_cpu_calls_run_the_plain_versions_and_launch_nothing():
    before = (vqNearest.launches, conv3x3SubpixelThin.launches)
    tokens, codebook = torch.randn(2, 10, 4), torch.randn(2, 20, 4)
    assert torch.equal(vqNearest(tokens, codebook), vqEncodePlain(tokens, codebook))
    x, w, b = torch.randn(1, 8, 5, 6), torch.randn(12, 8, 3, 3), torch.randn(12)
    assert torch.equal(conv3x3SubpixelThin(x, w, b, 2), conv3x3SubpixelPlain(x, w, b, 2))
    assert (vqNearest.launches, conv3x3SubpixelThin.launches) == before


@pytest.mark.parametrize("B,H,W,C,F,rate", [
    (1, 16, 24, 32, 12, 2),    # the RGB head's shape, scaled down
    (2, 8, 16, 16, 4, 2),
])
def test_thin_head_matches_pallas_interpret(B, H, W, C, F, rate):
    rng = np.random.default_rng(B * 100 + C)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, F)) * 0.1).astype(np.float32)
    b = rng.normal(size=(F,)).astype(np.float32)
    want = np.asarray(jaxThinHead(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), rate=rate,
                                  interpret=True))
    got = conv3x3SubpixelThin(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                              torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                              torch.from_numpy(b), rate)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-5)


def test_thin_head_gate():
    assert thinHeadSupported((1, 128, 384, 256), (12, 128, 3, 3), 2)
    assert thinHeadSupported((2, 4, 5, 7), (16, 4, 3, 3), 4)
    assert not thinHeadSupported((1, 6, 8, 8), (12, 6, 3, 3), 2)      # C % 4
    assert not thinHeadSupported((1, 8, 8, 8), (20, 8, 3, 3), 2)      # F > 16
    assert not thinHeadSupported((1, 8, 8, 8), (6, 8, 3, 3), 2)       # F % r^2
    assert not thinHeadSupported((1, 8, 8, 8), (12, 8, 1, 1), 2)      # not 3x3
    assert not thinHeadSupported((1, 8, 8, 8), (12, 4, 3, 3), 2)      # width mismatch


@pytest.mark.parametrize("m,T,k", [(2, 1536, 8192), (2, 384, 2048), (2, 96, 512),
                                   (1, 5, 7), (3, 1000, 1000), (1, 100000, 64)])
def test_split_plan_covers_k_without_empty_splits(m, T, k):
    splits, perSplit = splitPlan(m, T, k, 128, 64, 132)
    assert perSplit % 64 == 0
    assert (splits - 1) * perSplit < k <= splits * perSplit
    assert splits == 1 or -(-T // 128) * m * splits <= 4 * 132


def test_resident_fits_matches_jax():
    """Over a grid around the 8 MB budget, k rounded up to 128 as the JAX
    package rounds it."""
    for m in (1, 2, 3, 12):
        for k in (7, 128, 129, 512, 8192, 8193, 16383, 16384, 65536):
            for d in (3, 8, 16, 63, 64, 65, 300, 512):
                assert residentFits(m, k, d) == jaxResidentFits(m, k, d), (m, k, d)
    assert residentFits(2, 8192, 64) and residentFits(12, 8192, 16)      # qp-2, qp-12
    assert not residentFits(2, 16384, 64)             # the past-budget level 0


@pytest.mark.parametrize("m,T,k,d,integer", [
    (2, 40, 200, 300, False),     # d 300: past K1's shared-memory tile
    (1, 130, 300, 5, True),       # exact ties, k not a multiple of the 128 tile
    (2, 9, 129, 8, True),
    (1, 64, 1000, 16, False),
])
def test_grouped_pallas_interpret_matches_port(m, T, k, d, integer):
    """The JAX package's K1b (`vqEncodeGrouped`, interpret mode) and the port's
    `vqEncode`: codes identical, ties to the lowest index."""
    rng = np.random.default_rng(T + k + d)
    if integer:
        tokens = rng.integers(-2, 3, size=(m, T, d)).astype(np.float32)
        codebook = rng.integers(-2, 3, size=(m, k, d)).astype(np.float32)
    else:
        tokens = rng.normal(size=(m, T, d)).astype(np.float32)
        codebook = rng.normal(size=(m, k, d)).astype(np.float32)
    codebook[:, k // 2:k // 2 + k // 4] = codebook[:, :k // 4]      # duplicate codewords
    want = np.asarray(vqEncodeGrouped(jnp.asarray(tokens), jnp.asarray(codebook), interpret=True))
    x = torch.from_numpy(np.ascontiguousarray(tokens.transpose(1, 0, 2)))[:, :, :, None, None]
    got = vqEncode(x, torch.from_numpy(codebook))                    # [T, m, 1, 1]
    np.testing.assert_array_equal(got[:, :, 0, 0].numpy().T, want)
    np.testing.assert_array_equal(vqNearestGrouped(torch.from_numpy(tokens),
                                                   torch.from_numpy(codebook)).numpy(), want)
    if integer:
        dist = (codebook ** 2).sum(-1)[:, None, :] - 2 * np.einsum("mtd,mkd->mtk", tokens, codebook)
        assert ((dist == dist.min(-1, keepdims=True)).sum(-1) > 1).any()
        np.testing.assert_array_equal(want, dist.argmin(-1))


@pytest.mark.parametrize("m,k,d,route", [(2, 16384, 64, "K1b"), (2, 8192, 64, "K1"),
                                         (1, 64, 300, "K1b"), (1, 64, 256, "K1"),
                                         (12, 8192, 16, "K1"), (1, 140000, 16, "K1b")])
def test_vq_encode_routes_as_vq_encode_fused(monkeypatch, m, k, d, route):
    """K1 where `residentFits` and d <= K1's MAX_D, K1b otherwise; on the CPU
    both wrappers run the plain version and count no launch."""
    calls = []

    def spy(name, fn):
        def call(tokens, codebook):
            calls.append(name)
            return fn(tokens, codebook)
        return call

    monkeypatch.setattr(vq_cuda, "vqNearest", spy("K1", vq_cuda.vqNearest))
    monkeypatch.setattr(vq_grouped_cuda, "vqNearestGrouped",
                        spy("K1b", vq_grouped_cuda.vqNearestGrouped))
    rng = np.random.default_rng(k + d)
    x = torch.from_numpy(rng.normal(size=(1, m, d, 2, 3)).astype(np.float32))
    codebook = torch.from_numpy(rng.normal(size=(m, k, d)).astype(np.float32))
    before = (vqNearest.launches, vqNearestGrouped.launches)
    codes = vqEncode(x, codebook)
    assert calls == [route]
    assert (vqNearest.launches, vqNearestGrouped.launches) == before
    np.testing.assert_array_equal(codes.permute(1, 0, 2, 3).reshape(m, -1).numpy(),
                                  vqEncodePlain(latentTokens(x), codebook).numpy())


def test_codeword_norms_are_the_plain_versions_sums():
    codebook = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 2500, 33))
                                .astype(np.float32))
    want = torch.cat([(codebook[:, k0:k0 + 1024] ** 2).sum(-1) for k0 in range(0, 2500, 1024)], 1)
    assert torch.equal(codewordNorms(codebook), want)


@pytest.mark.parametrize("inChannels,features,grad,taken", [
    (8, 3, False, True),       # channel 8, F 12: the thin head
    (6, 3, False, False),      # C % 4 != 0
    (8, 8, False, False),      # F 32 > 16: the up-conv of a channel-8 shuffle block
    (8, 3, True, False),       # a gradient is needed
])
def test_thin_up_conv_takes_k2_only_where_the_jax_package_takes_pallas(
        monkeypatch, inChannels, features, grad, taken):
    """Fault C2: `PixelShuffleConv` gates K2 statically, as the JAX
    `_UpConv` gates its Pallas head (shapes it takes, no gradient); every
    other call is conv2d + pixel_shuffle, and all equal the plain version."""
    from mcquic_tpu_torch.nn import convs
    calls = []

    def spy(x, weight, bias, rate):
        calls.append(tuple(weight.shape))
        return conv3x3SubpixelThin(x, weight, bias, rate)

    monkeypatch.setattr(convs, "conv3x3SubpixelThin", spy)
    torch.manual_seed(inChannels + features)
    layer = convs.PixelShuffleConv(inChannels, features, 3, 2)
    x = torch.randn((2, inChannels, 5, 7), requires_grad=grad)
    with torch.set_grad_enabled(grad):
        y = layer(x)
    assert len(calls) == int(taken)
    assert torch.equal(y, conv3x3SubpixelPlain(x, layer[0].weight, layer[0].bias, 2))
    if grad:
        y.sum().backward()
        assert x.grad is not None
