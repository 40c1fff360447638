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
from mcquic_tpu_torch.ops.subpixel_cuda import (TILE, conv3x3SubpixelPlain, conv3x3SubpixelThin,
                                                thinHeadGrid, thinHeadSupported)
from mcquic_tpu_torch.ops import vq_cuda, vq_grouped_cuda
from mcquic_tpu_torch.ops.vq import (groupLatent, latentTokens, residentFits, ungroupLatent,
                                     vqDequantizeCodes, vqEncode, vqEncodePlain)
from mcquic_tpu_torch.ops.plan import splitsFor
from mcquic_tpu_torch.ops.vq_cuda import filterMargin, splitPlan, vqNearest
from mcquic_tpu_torch.ops.vq_grouped_cuda import (TILE_CODEWORDS, codewordNorms,
                                                   groupedSplitPlan, vqNearestGrouped)


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


@pytest.mark.parametrize("m,T,k", [(2, 1536, 16384), (2, 1536, 65536), (1, 512, 1024),
                                   (2, 77, 200), (3, 5, 7), (1, 130, 1000), (12, 1536, 16384),
                                   (1, 100000, 140000)])
def test_grouped_split_plan_covers_k_without_empty_splits(m, T, k):
    """K1b's plan: every codeword tile in one split, no split empty; a full
    wave of 132 blocks at the past-budget shapes (the first is the photo's
    real level 0), and at (1, 512, 1024, 512) at least twice the 64 blocks
    of a (128-token x 64-codeword) grid."""
    blockTokens, splits, perSplit = groupedSplitPlan(m, T, k, 132)
    tiles = -(-k // TILE_CODEWORDS)
    assert blockTokens in (128, 64)
    assert (splits - 1) * perSplit < tiles <= splits * perSplit
    blocks = -(-T // blockTokens) * m * splits
    if (m, T) == (2, 1536):
        assert blocks >= 132
    if (m, T, k) == (1, 512, 1024):
        assert blocks >= 2 * 64


@pytest.mark.parametrize("baseBlocks,tiles,target", [(24, 256, 264), (24, 1024, 264),
                                                     (4, 16, 264), (512, 14, 132), (32, 1, 132),
                                                     (32, 14, 132), (7, 5, 1), (1, 9, 4)])
def test_splits_for_covers_the_tiles_with_the_fewest_splits(baseBlocks, tiles, target):
    """The split rule shared by K1, K1b and K3: every tile in one split, no
    split empty, no more splits than the target asks for, and the smallest
    equal split size that keeps to that count."""
    splits, perSplit = splitsFor(baseBlocks, tiles, target)
    want = max(1, min(tiles, -(-target // baseBlocks)))
    assert 1 <= splits <= want
    assert (splits - 1) * perSplit < tiles <= splits * perSplit
    assert perSplit == 1 or -(-tiles // (perSplit - 1)) > want
    if (baseBlocks, tiles, target) == (24, 256, 264):     # K1b at k 16384: 11 splits
        assert (splits, perSplit) == (11, 24)


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


def test_plain_search_pads_a_short_last_chunk_like_jax():
    """k 4097: the default 1024-codeword chunks leave codeword 4096 alone in
    the last chunk, and it repeats codeword 3. The plain version pads that
    chunk to full width with 1e4, as `vqEncodeChunked` does, so tokens equal
    to codeword 3 take the lower index, and the codes equal the JAX
    package's bit for bit."""
    rng = np.random.default_rng(4097)
    x = _nhwmd(1, 8, 10, 2, 64, rng)
    codebook = rng.normal(size=(2, 4097, 64)).astype(np.float32)
    codebook[:, 4096] = codebook[:, 3]
    x[0, 0, :5] = codebook[:, 3]
    got = _portCodes(x, codebook)
    want = np.asarray(jaxVqEncodeChunked(jnp.asarray(x), jnp.asarray(codebook)))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0, :5] == 3).all()
    tokens = latentTokens(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 4, 1, 2))))
    np.testing.assert_array_equal(
        vqEncodePlain(tokens, torch.from_numpy(codebook)).numpy(),
        vqEncodePlain(tokens, torch.from_numpy(codebook), chunk=4097).numpy())


def _truncateTf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: its low 13 bits dropped."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _k1FilterModel(tokens: torch.Tensor, codebook: torch.Tensor, splits: int,
                   tilesPerSplit: int):
    """K1's arithmetic on the CPU: per split, 64-codeword tiles in order;
    dot~ from TF32-truncated operands with fp32 sums; each lane's margin
    over its 16 columns of a tile (the columns 8 n + 2 tq + {0, 1}) from
    `filterMargin` and that lane's largest norms; the running least upper
    bound U per token folded in before a tile's candidates (lower bound <=
    U) are taken; the candidates rescored against the exhaustive fp32
    distances, lowest index on ties. Returns (codes, rescored pairs)."""
    m, T, d = tokens.shape
    k = codebook.shape[1]
    kappa, eta = filterMargin(d)
    c2 = codewordNorms(codebook)
    cn = c2.sqrt()
    exact = c2[:, None, :] - 2.0 * torch.bmm(tokens, codebook.transpose(1, 2))
    approx = c2[:, None, :] - 2.0 * torch.bmm(_truncateTf32(tokens),
                                              _truncateTf32(codebook).transpose(1, 2))
    xk = kappa * tokens.square().sum(-1).sqrt()                       # [m, T]
    best = torch.full((m, T), float("inf"))
    arg = torch.zeros((m, T), dtype=torch.int64)
    rescored = 0
    for s in range(splits):
        bound = torch.full((m, T), float("inf"))
        splitBest = torch.full((m, T), float("inf"))
        splitArg = torch.zeros((m, T), dtype=torch.int64)
        for j0 in range(s * tilesPerSplit * 64, min(k, (s + 1) * tilesPerSplit * 64), 64):
            j1 = min(k, j0 + 64, (s + 1) * tilesPerSplit * 64)
            lane = (torch.arange(j1 - j0) % 8) // 2                   # the column's lane tq
            margin = torch.empty((m, T, j1 - j0))
            for tq in range(4):
                cols = (lane == tq).nonzero().flatten() + j0
                if cols.numel():
                    D = (xk * cn[:, cols].max(-1).values[:, None]
                         + eta * c2[:, cols].max(-1).values[:, None])
                    margin[..., cols - j0] = D[..., None]
            tile = approx[..., j0:j1]
            bound = torch.minimum(bound, (tile + margin).min(-1).values)
            candidate = tile - margin <= bound[..., None]
            rescored += int(candidate.sum())
            dist = torch.where(candidate, exact[..., j0:j1], torch.tensor(float("inf")))
            tileMin, tileArg = dist.min(-1)
            better = tileMin < splitBest
            splitBest = torch.where(better, tileMin, splitBest)
            splitArg = torch.where(better, tileArg + j0, splitArg)
        better = splitBest < best      # splits in increasing k: the earlier keeps ties
        best = torch.where(better, splitBest, best)
        arg = torch.where(better, splitArg, arg)
    return arg.to(torch.int32), rescored


def _adversarial(kind, m, T, k, d, rng):
    if kind == "normal":
        return (rng.normal(size=(m, T, d)).astype(np.float32),
                rng.normal(size=(m, k, d)).astype(np.float32))
    tokens = rng.integers(-2, 3, size=(m, T, d)).astype(np.float32)
    codebook = rng.integers(-2, 3, size=(m, k, d)).astype(np.float32)
    if kind == "pairs":       # one coordinate 2048 against 2049: TF32 reads both as 2048
        pairs = [(e - 1, e) for e in range(64, k, 64)] + [(10, 11), (k // 2 + 1, k // 2)]
        for n, (a, b) in enumerate(pairs):
            codebook[:, b] = codebook[:, a]
            codebook[:, a, n % d] = 2048.0
            codebook[:, b, n % d] = 2049.0
        big = rng.integers(0, len(pairs), size=(m, T)) % d
        np.put_along_axis(tokens, big[..., None],
                          (2048.0 + rng.integers(0, 2, size=(m, T, 1))).astype(np.float32), 2)
    if kind == "duplicates":  # exact ties across every tile boundary
        for e in range(64, k, 64):
            codebook[:, e] = codebook[:, e - 1]
            tokens[:, (e // 64) % T] = codebook[:, e - 1]
    return tokens, codebook


@pytest.mark.parametrize("kind,m,T,k,d", [
    ("normal", 2, 256, 8192, 64),      # qp-2 level 0's widths, T cut
    ("normal", 1, 256, 1024, 8),       # Neon's last level
    ("normal", 12, 64, 8192, 16),      # qp-12 level 0's widths, T cut
    ("ties", 2, 300, 2000, 16),
    ("pairs", 1, 300, 2000, 8),
    ("pairs", 2, 200, 4100, 64),
    ("duplicates", 2, 200, 4100, 64),
    ("duplicates", 1, 256, 1024, 8),
])
def test_k1_filter_model_returns_the_exhaustive_argmin(kind, m, T, k, d):
    """The filter and the margin of csrc/vq_encode.cu, modelled on the CPU
    with the kernel's split plan on 132 SMs, give exactly the codes of an
    exhaustive fp32 argmin; on random data about ln(tiles) pairs per token
    are rescored, and the near-ties of the integer cases (which TF32 cannot
    tell apart) are all handed to the rescoring."""
    rng = np.random.default_rng(k + d + T)
    tokens, codebook = (torch.from_numpy(a) for a in _adversarial(kind, m, T, k, d, rng))
    blockTokens, splits, tilesPerSplit = vq_cuda.k1Plan(m, T * 6, k, d, 132)
    got, rescored = _k1FilterModel(tokens, codebook, splits, tilesPerSplit)
    want = vqEncodePlain(tokens, codebook, chunk=k)
    exact = (codewordNorms(codebook)[:, None, :]
             - 2.0 * torch.bmm(tokens, codebook.transpose(1, 2)))
    assert torch.equal(want.long(), exact.argmin(-1))
    assert torch.equal(got, want)
    perToken = rescored / (m * T)
    assert perToken >= splits
    if kind == "normal":
        assert perToken <= 4 * splits * (1 + np.log(-(-k // 64) / splits)), perToken
    if kind in ("ties", "pairs"):
        # the filter matters: TF32 alone picks another codeword on some tokens
        approx = (codewordNorms(codebook)[:, None, :] - 2.0 * torch.bmm(
            _truncateTf32(tokens), _truncateTf32(codebook).transpose(1, 2)))
        assert kind == "ties" or (approx.argmin(-1) != exact.argmin(-1)).any()


@pytest.mark.parametrize("m,T,k,d", [(2, 1536, 8192, 64), (2, 384, 2048, 64), (2, 96, 512, 64),
                                     (1, 1, 1024, 8), (1, 256, 1024, 8), (12, 15360, 8192, 16),
                                     (1, 300, 130, 256), (3, 77, 200, 177), (2, 5, 7, 3)])
def test_k1_plan_covers_k_and_fits_shared_memory(m, T, k, d):
    """K1's plan: 128-token blocks unless d rounded up to 8 passes WIDE_D (the
    token tile and the 3-stage ring of 64-codeword tiles would not fit the
    card's 227 KB), 64 then with a 2-stage ring (as for d up to 16); every
    codeword tile in one split and none empty; the qp-2 level 0 fills two
    blocks per SM."""
    blockTokens, splits, tilesPerSplit = vq_cuda.k1Plan(m, T, k, d, 132)
    tiles = -(-k // vq_cuda.TILE_CODEWORDS)
    assert (splits - 1) * tilesPerSplit < tiles <= splits * tilesPerSplit
    dp = -(-d // 8) * 8
    assert blockTokens == (128 if dp <= vq_cuda.WIDE_D else 64)
    stages = 3 if blockTokens == 128 and dp > 16 else 2
    shared = 4 * (blockTokens * (dp + 4) + stages * (64 * (dp + 4) + 128))
    assert shared <= 232448
    blocks = -(-T // blockTokens) * m * splits
    if (m, T, k) == (2, 1536, 8192):
        assert (splits, blocks) == (11, 264)
    assert splits == 1 or blocks <= 4 * 132


def _roundTf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 with two integer operations, ties away from zero
    (csrc/tf32_mma.cuh::split)."""
    return ((x.float().contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def test_k2_3xtf32_conv_stays_within_a_tenth_of_the_tolerance():
    """K2's arithmetic before any card run: at the photo head's widths (C 128,
    F 12; the image cut to 24x40), x and the weights split hi + lo with hi
    rounded to TF32 and lo truncated by the tensor core, the products
    lo.hi + hi.lo + hi.hi summed in fp32, against the fp64 conv: within
    1e-5, a tenth of the card's 1e-4 gate. One TF32 product is worse."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(1, 128, 24, 40)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(12, 128, 3, 3)) * 0.05).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32))
    xHi, wHi = _roundTf32(x), _roundTf32(w)
    xLo, wLo = _truncateTf32(x - xHi), _truncateTf32(w - wHi)
    conv = torch.nn.functional.conv2d
    emulated = conv(xLo, wHi, padding=1) + conv(xHi, wLo, padding=1) + conv(xHi, wHi, b, padding=1)
    exact = conv(x.double(), w.double(), b.double(), padding=1)
    err = (emulated.double() - exact).abs().max().item()
    assert err <= 1e-5, err
    oneProduct = conv(_truncateTf32(x), _truncateTf32(w), b, padding=1)
    assert (oneProduct.double() - exact).abs().max().item() > 10 * err


@pytest.mark.parametrize("B,H,W", [(1, 256, 384), (10, 256, 384), (2, 7, 33), (1, 1, 1)])
def test_k2_grid_covers_the_image_in_one_wave_at_the_photo(B, H, W):
    """K2's grid: every input pixel in one tile; the photo's 384 tiles fit one
    wave of 3 blocks per SM on 132 SMs."""
    cols, rows, batch = thinHeadGrid(B, H, W)
    th, tw = TILE
    assert (cols - 1) * tw < W <= cols * tw and (rows - 1) * th < H <= rows * th and batch == B
    if (B, H, W) == (1, 256, 384):
        assert cols * rows == 384 <= 3 * 132
