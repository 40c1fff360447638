"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips where torch sees no CUDA card.
This file imports only torch and the port, so it also runs on a machine
without the JAX package (tests/conftest.py imports JAX, hence
`--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from mcquic_tpu_torch.models.compressor import Compressor
from mcquic_tpu_torch.models.generator import blockCausalMask
from mcquic_tpu_torch.nn.convs import PixelShuffleConv
from mcquic_tpu_torch.ops import attention_cuda, subpixel_cuda, vq_cuda, vq_grouped_cuda
from mcquic_tpu_torch.ops.attention import flashAttentionPlain
from mcquic_tpu_torch.ops.attention_cuda import attentionPlan, flashAttention
from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelPlain, conv3x3SubpixelThin
from mcquic_tpu_torch.ops.vq import groupLatent, vqEncode, vqEncodePlain
from mcquic_tpu_torch.ops.vq_cuda import k1Plan, vqNearest
from mcquic_tpu_torch.ops.vq_grouped_cuda import groupedSplitPlan, vqNearestGrouped
from mcquic_tpu_torch.utils import exactFp32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    return torch.device("cuda")


def test_kernel_libraries_build(cuda):
    vq_cuda.build()
    vq_grouped_cuda.build()
    subpixel_cuda.build()
    attention_cuda.build()


@pytest.mark.parametrize("m,T,k,d", [(2, 1536, 8192, 64), (2, 96, 512, 64), (1, 77, 200, 8),
                                     (3, 1000, 1000, 40), (2, 5, 7, 3)])
def test_k1_matches_plain_with_exact_ties(cuda, m, T, k, d):
    """Duplicated codewords give exact ties; both must take the lower index."""
    gen = torch.Generator(device=cuda).manual_seed(m * T + k)
    tokens = torch.randn((m, T, d), device=cuda, generator=gen)
    codebook = torch.randn((m, k, d), device=cuda, generator=gen)
    codebook[:, k // 2:] = codebook[:, :k - k // 2].clone()
    launches = vqNearest.launches
    with exactFp32():
        got = vqNearest(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
    assert vqNearest.launches == launches + 1
    assert torch.equal(got, want)
    if k % 2 == 0:    # every codeword past k/2 repeats one below it
        assert int(got.max()) < k // 2


@pytest.mark.parametrize("m,T,k,d", [(1, 1, 1024, 8), (1, 256, 1024, 8),    # Neon's levels
                                     (12, 2000, 8192, 16),                  # qp-12's width
                                     (2, 500, 1000, 64), (1, 300, 130, 256)])   # k past whole tiles
def test_k1_matches_plain_at_the_neon_qp12_and_ragged_shapes(cuda, m, T, k, d):
    """Duplicated codewords give exact ties; every code must equal the plain
    version's."""
    gen = torch.Generator(device=cuda).manual_seed(m * T + k + d)
    tokens = torch.randn((m, T, d), device=cuda, generator=gen)
    codebook = torch.randn((m, k, d), device=cuda, generator=gen)
    codebook[:, k // 2:] = codebook[:, :k - k // 2].clone()
    launches = vqNearest.launches
    with exactFp32():
        got = vqNearest(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
    torch.cuda.synchronize()
    assert vqNearest.launches == launches + 1
    assert torch.equal(got, want)


def test_k1_takes_a_wider_d_after_a_narrower_one(cuda):
    """d in increasing order through each of K1's kernel instances (d up to
    16, 64, 176 and 256): shared memory is allowed per instance for the
    largest d it takes, so a wider d after a narrower one still launches."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for d in (3, 8, 16, 17, 40, 64, 65, 168, 176, 177, 256):
        tokens = torch.randn((1, 130, d), device=cuda, generator=gen)
        codebook = torch.randn((1, 300, d), device=cuda, generator=gen)
        with exactFp32():
            got = vqNearest(tokens, codebook)
            want = vqEncodePlain(tokens, codebook)
        torch.cuda.synchronize()
        assert torch.equal(got, want), d


def test_k1_ties_with_a_duplicate_alone_in_the_last_chunk(cuda):
    """k 4097: the plain version's default 1024-codeword chunks leave
    codeword 4096 alone in its chunk, and it repeats codeword 5. Tokens equal
    to it tie exactly; the lowest index must win in K1 and in the plain
    version with the default chunk."""
    gen = torch.Generator(device=cuda).manual_seed(4097)
    tokens = torch.randn((2, 600, 64), device=cuda, generator=gen)
    codebook = torch.randn((2, 4097, 64), device=cuda, generator=gen)
    codebook[:, 4096] = codebook[:, 5]
    tokens[:, :40] = codebook[:, 5:6]
    with exactFp32():
        got = vqNearest(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got[:, :40] == 5).all()


def _plantAcrossSplits(m, T, k, splits, tilesPerSplit, tokens, codebook):
    """Repeat the codewords just below each split boundary (and each tile
    boundary of the first split) just above it, and set a token equal to
    each; returns the (token, lowest index) pairs."""
    boundaries = [s * tilesPerSplit * 64 for s in range(1, splits)]
    boundaries += [64 * i for i in range(1, tilesPerSplit) if 64 * i < k]
    planted = []
    for n, boundary in enumerate(boundaries):
        for i in range(2):
            low, high, token = boundary - 1 - i, boundary + i, (2 * n + i) % T
            if high < k:
                codebook[:, high] = codebook[:, low]
                tokens[:, token] = codebook[:, low]
                planted.append((token, low))
    return {token: low for token, low in planted}     # a token planted twice keeps its last


@pytest.mark.parametrize("m,T,k,d", [(2, 1536, 8192, 64), (2, 600, 4100, 64), (1, 256, 1024, 8),
                                     (3, 200, 2000, 40)])
def test_k1_ties_across_split_boundaries_go_to_the_lowest_index(cuda, m, T, k, d):
    """The split route: each split's argmin goes through one 64-bit
    atomicMin per token; ties across splits and tiles must go to the lower
    index."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, perSplit = k1Plan(m, T, k, d, sms)
    assert splits > 1
    gen = torch.Generator(device=cuda).manual_seed(m * T + k + d)
    tokens = torch.randn((m, T, d), device=cuda, generator=gen)
    codebook = torch.randn((m, k, d), device=cuda, generator=gen)
    planted = _plantAcrossSplits(m, T, k, splits, perSplit, tokens, codebook)
    assert planted
    with exactFp32():
        got = vqNearest(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for token, low in planted.items():
        assert (got[:, token] == low).all(), (token, low, got[:, token])


@pytest.mark.parametrize("m,T,k,d", [(1, 512, 2000, 8), (2, 600, 4100, 64), (1, 100, 300, 8)])
def test_k1_near_ties_that_tf32_cannot_see(cuda, m, T, k, d):
    """Integer data on which fp32 is exact: codeword pairs whose one large
    coordinate is 2048 in one and 2049 in the other, which TF32 (11
    significant bits) reads alike, and tokens whose coordinate there is 2048
    or 2049. Every distance is an integer below 2^24, so the pair's
    distances differ by 1 or tie exactly, and K1's filter must hand both to
    the fp32 rescoring. Pairs sit within tiles, across tile and split
    boundaries, and with 2049 at the lower index."""
    gen = torch.Generator(device=cuda).manual_seed(k + d)
    tokens = torch.randint(-2, 3, (m, T, d), device=cuda, generator=gen).float()
    codebook = torch.randint(-2, 3, (m, k, d), device=cuda, generator=gen).float()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, perSplit = k1Plan(m, T, k, d, sms)
    edges = [s * perSplit * 64 for s in range(1, splits)] + [64, 128, k - 1]
    pairs = [(e - 1, e) for e in edges if 0 < e < k] + [(10, 11), (k // 2 + 1, k // 2)]
    for n, (a, b) in enumerate(pairs):
        p = n % d
        codebook[:, b] = codebook[:, a]
        codebook[:, a, p] = 2048.0
        codebook[:, b, p] = 2049.0
    big = torch.randint(0, len(pairs), (m, T), device=cuda, generator=gen) % d
    values = 2048.0 + torch.randint(0, 2, (m, T), device=cuda, generator=gen).float()
    tokens.scatter_(2, big[..., None], values[..., None])
    with exactFp32():
        got = vqNearest(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
        exact = ((codebook * codebook).sum(-1)[:, None].double()
                 - 2 * torch.bmm(tokens.double(), codebook.double().transpose(1, 2)))
    torch.cuda.synchronize()
    assert exact.abs().max().item() < 2 ** 24
    gaps = exact.sort(-1).values
    assert ((gaps[..., 1] - gaps[..., 0]) <= 1).float().mean().item() > 0.5   # near-ties abound
    assert torch.equal(got, want)
    assert torch.equal(got.long(), exact.argmin(-1))


K1B_SHAPES = [(2, 1536, 16384, 64), (2, 1536, 65536, 64), (1, 512, 1024, 512)]


@pytest.mark.parametrize("m,T,k,d", K1B_SHAPES + [(2, 77, 200, 300), (3, 5, 7, 3),
                                                  (1, 130, 1000, 257), (2, 300, 129, 33)])
def test_k1b_matches_plain_with_exact_ties(cuda, m, T, k, d):
    """Duplicated codewords give exact ties; both must take the lower index.
    Every code must equal the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(m * T + k + d)
    tokens = torch.randn((m, T, d), device=cuda, generator=gen)
    codebook = torch.randn((m, k, d), device=cuda, generator=gen)
    codebook[:, k // 2:] = codebook[:, :k - k // 2].clone()
    launches = vqNearestGrouped.launches
    with exactFp32():
        got = vqNearestGrouped(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
    torch.cuda.synchronize()
    assert vqNearestGrouped.launches == launches + 1
    assert torch.equal(got, want)
    if k % 2 == 0:
        assert int(got.max()) < k // 2


@pytest.mark.parametrize("m,T,k,d", [(1, 200, 300, 5), (2, 1000, 70, 16)])
def test_k1b_small_integers_tie_at_zero_and_below(cuda, m, T, k, d):
    """Small integers make every distance exact: many tokens tie at 0 and at
    negative distances, and the lowest index must win each tie."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    tokens = torch.randint(-2, 3, (m, T, d), device=cuda, generator=gen).float()
    codebook = torch.randint(-2, 3, (m, k, d), device=cuda, generator=gen).float()
    codebook[:, [3, 5]] = 0                   # zero tokens tie at distance 0 between them
    tokens[:, :4] = 0
    with exactFp32():
        got = vqNearestGrouped(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
        dist = (codebook * codebook).sum(-1)[:, None] - 2 * torch.bmm(tokens, codebook.transpose(1, 2))
    assert ((dist == dist.min(-1, keepdim=True).values).sum(-1) > 1).any()
    assert (dist.min(-1).values == 0).any()
    assert torch.equal(got, want)
    assert torch.equal(got.long(), dist.argmin(-1))


@pytest.mark.parametrize("m,T,k,d", [(2, 1536, 16384, 64), (2, 700, 16400, 72),
                                     (1, 512, 1000, 520), (12, 300, 9000, 72), (3, 200, 4097, 33)])
def test_k1b_ties_across_split_boundaries_go_to_the_lowest_index(cuda, m, T, k, d):
    """Codewords just below each split boundary are repeated just above it,
    and tokens equal to them tie exactly across the two splits: the lower
    index must win, and every code must equal the plain version's. d not a
    multiple of the 32-wide chunk (72, 520, 33), k not a multiple of the
    64-codeword tile (16400, 1000, 9000, 4097), m up to 12."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, perSplit = groupedSplitPlan(m, T, k, sms)
    assert splits > 1
    gen = torch.Generator(device=cuda).manual_seed(m * T + k + d)
    tokens = torch.randn((m, T, d), device=cuda, generator=gen)
    codebook = torch.randn((m, k, d), device=cuda, generator=gen)
    planted = []
    for s in range(1, splits):
        boundary = s * perSplit * 64
        for i in range(3):
            low, high, token = boundary - 1 - i, boundary + i, (3 * (s - 1) + i) % T
            if high < k:
                codebook[:, high] = codebook[:, low]
                tokens[:, token] = codebook[:, low]
                planted.append((token, low))
    assert planted
    with exactFp32():
        got = vqNearestGrouped(tokens, codebook)
        # one chunk: the default 1024-codeword chunks leave codeword 4096 of
        # k 4097 alone in a chunk, whose one-column product cuBLAS rounds
        # otherwise, and the plain version then splits an exact tie
        want = vqEncodePlain(tokens, codebook, chunk=k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    last = {token: low for token, low in planted}          # a token planted twice keeps its last
    for token, low in last.items():
        assert (got[:, token] == low).all(), (token, low, got[:, token])


@pytest.mark.parametrize("m,T,k,d", [(3, 200, 4097, 33), (2, 600, 4097, 64)])
def test_k1b_ties_across_split_boundaries_with_the_default_chunk(cuda, m, T, k, d):
    """The split-boundary ties of the test above at k 4097, against the plain
    version with its default 1024-codeword chunks: since the plain version
    pads a short last chunk, codeword 4096 alone in its chunk no longer
    splits an exact tie, and every code must equal the plain version's."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, perSplit = groupedSplitPlan(m, T, k, sms)
    assert splits > 1
    gen = torch.Generator(device=cuda).manual_seed(m * T + k + d)
    tokens = torch.randn((m, T, d), device=cuda, generator=gen)
    codebook = torch.randn((m, k, d), device=cuda, generator=gen)
    planted = _plantAcrossSplits(m, T, k, splits, perSplit, tokens, codebook)
    codebook[:, 4096] = codebook[:, 7]                   # alone in the last chunk
    tokens[:, -5:] = codebook[:, 7:8]
    with exactFp32():
        got = vqNearestGrouped(tokens, codebook)
        want = vqEncodePlain(tokens, codebook)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got[:, -5:] == 7).all()
    for token, low in planted.items():
        if token < T - 5:
            assert (got[:, token] == low).all(), (token, low, got[:, token])


def test_vq_encode_sends_past_budget_and_wide_codebooks_to_k1b(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    cases = [((2, 64, 16384), "K1b"), ((2, 64, 8192), "K1"), ((1, 300, 64), "K1b"),
             ((1, 256, 64), "K1")]                    # (m, d, k)
    for (m, d, k), kernel in cases:
        x = torch.randn((1, m, d, 4, 6), device=cuda, generator=gen)
        codebook = torch.randn((m, k, d), device=cuda, generator=gen)
        before = (vqNearest.launches, vqNearestGrouped.launches)
        with exactFp32():
            codes = vqEncode(x, codebook)
        after = (vqNearest.launches - before[0], vqNearestGrouped.launches - before[1])
        assert after == ((0, 1) if kernel == "K1b" else (1, 0)), (m, d, k)
        tokens = x.permute(1, 0, 3, 4, 2).reshape(m, -1, d).contiguous()
        assert torch.equal(codes.permute(1, 0, 2, 3).reshape(m, -1), vqEncodePlain(tokens, codebook))


@pytest.mark.parametrize("inChannels,features", [(8, 3), (6, 3), (8, 5), (16, 8)])
def test_thin_up_conv_gate_runs_k2_only_where_it_fits(cuda, inChannels, features):
    """Channel 8 at F 12 takes K2; C % 4 != 0 and F > 16 take conv2d +
    pixel_shuffle without an error; both equal the plain version."""
    torch.manual_seed(inChannels * features)
    layer = PixelShuffleConv(inChannels, features, 3, 2).to(cuda).eval()
    x = torch.randn((2, inChannels, 9, 14), device=cuda)
    taken = subpixel_cuda.thinHeadSupported(x.shape, layer[0].weight.shape, 2)
    launches = conv3x3SubpixelThin.launches
    with exactFp32(), torch.no_grad():
        got = layer(x)
        want = conv3x3SubpixelPlain(x, layer[0].weight, layer[0].bias, 2)
    assert conv3x3SubpixelThin.launches == launches + int(taken)
    assert (got - want).abs().max().item() <= 1e-4


def test_thin_up_conv_under_autograd_takes_the_plain_path(cuda):
    torch.manual_seed(0)
    layer = PixelShuffleConv(8, 3, 3, 2).to(cuda)
    x = torch.randn((1, 8, 6, 7), device=cuda, requires_grad=True)
    launches = conv3x3SubpixelThin.launches
    with exactFp32():
        y = layer(x)
        y.square().sum().backward()
    assert conv3x3SubpixelThin.launches == launches
    assert x.grad is not None and layer[0].weight.grad is not None
    assert (y - conv3x3SubpixelPlain(x, layer[0].weight, layer[0].bias, 2)).abs().max().item() <= 1e-4


def test_channel_8_compressor_decodes_on_the_card_like_the_cpu(cuda):
    """Channel 8: every shuffle block is a thin up-conv with F 32 > 16."""
    torch.manual_seed(1)
    cpu = Compressor(8, 2, [16, 8]).eval()
    card = Compressor(8, 2, [16, 8]).to(cuda).eval()
    card.load_state_dict(cpu.state_dict())
    codes = [torch.randint(0, 16, (1, 2, 4, 4)), torch.randint(0, 8, (1, 2, 2, 2))]
    with exactFp32(), torch.inference_mode():
        want = cpu.decode(codes)
        got = card.decode([c.to(cuda) for c in codes]).cpu()
    assert got.shape == want.shape == (1, 3, 64, 64)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,C,H,W,F,r", [(1, 128, 96, 64, 12, 2), (2, 16, 33, 45, 12, 2),
                                         (1, 20, 17, 70, 3, 1), (1, 128, 8, 8, 16, 4)])
def test_k2_matches_conv_and_shuffle(cuda, B, C, H, W, F, r):
    gen = torch.Generator(device=cuda).manual_seed(C * H + W)
    x = torch.randn((B, C, H, W), device=cuda, generator=gen)
    w = torch.randn((F, C, 3, 3), device=cuda, generator=gen) * 0.05
    b = torch.randn((F,), device=cuda, generator=gen)
    launches = conv3x3SubpixelThin.launches
    with exactFp32(), torch.no_grad():
        got = conv3x3SubpixelThin(x, w, b, r)
        want = conv3x3SubpixelPlain(x, w, b, r)
    assert conv3x3SubpixelThin.launches == launches + 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,C,H,W,F,r", [(10, 128, 256, 384, 12, 2),    # the speed batch's head
                                         (1, 4, 13, 29, 12, 2), (2, 20, 7, 33, 3, 1),
                                         (1, 20, 9, 37, 16, 4), (3, 4, 31, 5, 16, 4),
                                         (1, 8, 11, 17, 9, 3)])
def test_k2_matches_conv_and_shuffle_at_the_batch_and_odd_shapes(cuda, B, C, H, W, F, r):
    """B 10 at the photo's head shape; odd H and W (the 4-byte copy and store
    routes), C 4 and 20 (a chunk of 8 channels partly past C), F 3 / r 1,
    F 16 / r 4 and F 9 / r 3."""
    gen = torch.Generator(device=cuda).manual_seed(B * C * H + W + F)
    x = torch.randn((B, C, H, W), device=cuda, generator=gen)
    w = torch.randn((F, C, 3, 3), device=cuda, generator=gen) * 0.05
    b = torch.randn((F,), device=cuda, generator=gen)
    launches = conv3x3SubpixelThin.launches
    with exactFp32(), torch.no_grad():
        got = conv3x3SubpixelThin(x, w, b, r)
        want = conv3x3SubpixelPlain(x, w, b, r)
        noBias = conv3x3SubpixelThin(x, w, None, r) - conv3x3SubpixelPlain(x, w, None, r)
    torch.cuda.synchronize()
    assert conv3x3SubpixelThin.launches == launches + 2
    assert got.shape == want.shape == (B, F // (r * r), r * H, r * W)
    assert (got - want).abs().max().item() <= 1e-4
    assert noBias.abs().max().item() <= 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn((1, 6, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="not taken by the kernel"):
        conv3x3SubpixelThin(x, torch.randn((12, 6, 3, 3), device=cuda), None, 2)
    with pytest.raises(TypeError, match="fp32"):
        conv3x3SubpixelThin(x.double()[:, :4], torch.randn((12, 4, 3, 3), device=cuda).double(),
                            None, 2)
    w = torch.randn((12, 8, 3, 3), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3SubpixelThin(torch.randn((1, 8, 4, 4), device=cuda), w, None, 2)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        vqNearest(torch.randn((1, 4, 300), device=cuda), torch.randn((1, 8, 300), device=cuda))
    with pytest.raises(TypeError, match="fp32"):
        vqNearest(torch.randn((1, 4, 8), device=cuda).half(), torch.randn((1, 8, 8), device=cuda).half())


GEN_LENGTHS = [1, 1, 4, 4, 16, 16, 64, 64, 256]     # gen_stage2_neonA, 426 tokens


@pytest.mark.parametrize("B,H,Tq,Tk,D", [(4, 8, 1, 1, 64), (4, 8, 4, 10, 64), (4, 8, 256, 426, 64),
                                         (2, 4, 40, 130, 8), (1, 2, 33, 7, 128), (3, 1, 17, 65, 40),
                                         (1, 2, 5, 33, 6), (2, 1, 3, 70, 127)]
                         + [(4, 8, hw, sum(GEN_LENGTHS[:i + 1]), 64)
                            for i, hw in enumerate(GEN_LENGTHS)
                            if (hw, sum(GEN_LENGTHS[:i + 1])) not in ((1, 1), (4, 10), (256, 426))])
def test_k3_matches_plain_over_a_cache_prefix(cuda, B, H, Tq, Tk, D):
    """k and v are a prefix slice of a longer [B, Lmax, H, D] cache; the
    cases include the nine KV-cached levels of gen_stage2_neonA."""
    gen = torch.Generator(device=cuda).manual_seed(B * Tq + Tk + D)
    q = torch.randn((B, Tq, H, D), device=cuda, generator=gen)
    cache = torch.randn((2, B, Tk + 9, H, D), device=cuda, generator=gen)
    k, v = cache[0, :, :Tk], cache[1, :, :Tk]
    launches = flashAttention.launches
    with torch.no_grad():
        got = flashAttention(q, k, v)
        want = flashAttentionPlain(q, k, v)
    torch.cuda.synchronize()
    assert flashAttention.launches == launches + 1
    assert got.shape == (B, Tq, H, D)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("lengths", [GEN_LENGTHS, [1, 1, 4]])
def test_k3_matches_plain_under_the_block_causal_mask(cuda, lengths):
    t = sum(lengths)
    gen = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = (torch.randn((4, t, 8, 64), device=cuda, generator=gen) for _ in range(3))
    full = torch.from_numpy(blockCausalMask(lengths)).to(cuda, torch.int8)
    with torch.no_grad():
        for prefix in (t, t - lengths[-1]):           # the uncached path's mask slices
            if prefix == 0:
                continue
            mask = full[:prefix, :prefix]
            got = flashAttention(q[:, :prefix], k[:, :prefix], v[:, :prefix], mask)
            want = flashAttentionPlain(q[:, :prefix], k[:, :prefix], v[:, :prefix], mask)
            assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("Tq,Tk", [(1, 1), (1, 2), (4, 6), (4, 10), (16, 26), (16, 42),
                                   (64, 106), (64, 170), (256, 426)])
def test_k3_matches_plain_at_var_head_dim_96(cuda, Tq, Tk):
    """GeneratorVAR's sampling at its default width (embedDim 1536, 16 heads,
    head dim 96) and CFG batch 8: every level's queries against the prefix
    of a [8, 426, 16, 96] KV cache, q and k l2-normalized (q scaled by 4),
    scale 1.0, no mask."""
    gen = torch.Generator(device=cuda).manual_seed(Tq + Tk)
    q = torch.randn((8, Tq, 16, 96), device=cuda, generator=gen)
    q = 4 * q / q.norm(dim=-1, keepdim=True)
    cache = torch.randn((2, 8, 426, 16, 96), device=cuda, generator=gen)
    k = cache[0, :, :Tk] / cache[0, :, :Tk].norm(dim=-1, keepdim=True)
    v = cache[1, :, :Tk]
    with torch.no_grad():
        got = flashAttention(q, k, v, None, 1.0)
        want = flashAttentionPlain(q, k, v, None, 1.0)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,H,Tq,Tk,D", [(4, 8, 256, 426, 64), (4, 8, 64, 170, 32),
                                         (4, 8, 64, 106, 128), (4, 8, 16, 42, 64),
                                         (4, 8, 16, 26, 64), (4, 8, 1, 1, 32), (4, 8, 1, 77, 128),
                                         (2, 2, 1, 1000, 64), (1, 1, 300, 45, 32)])
def test_k3_split_and_unsplit_routes_match_plain(cuda, B, H, Tq, Tk, D):
    """Both routes of the plan: one pass, and keys split across blocks with
    the merge kernel after; Tk not a multiple of the 32-key tile, Tq 1, and
    D 32 / 64 / 128."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, _ = attentionPlan(B, H, Tq, Tk, sms)
    gen = torch.Generator(device=cuda).manual_seed(B * Tq + Tk + D)
    q = torch.randn((B, Tq, H, D), device=cuda, generator=gen)
    k, v = (torch.randn((B, Tk, H, D), device=cuda, generator=gen) for _ in range(2))
    launches = flashAttention.launches
    with torch.no_grad():
        got = flashAttention(q, k, v)
        want = flashAttentionPlain(q, k, v)
    torch.cuda.synchronize()
    assert flashAttention.launches == launches + 1
    assert (got - want).abs().max().item() <= 1e-4, splits
    if (Tq, Tk) in ((256, 426), (1, 1000)):
        assert splits > 1
    if (Tq, Tk) in ((16, 26), (1, 1)):
        assert splits == 1


def _unalignedViews(case, cuda):
    """(q, k) for one case of the 4-byte copy route; v is k."""
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    if case == "base":        # base pointer 4 bytes past 16-byte alignment
        flat = torch.randn(1 + 6 * 2 * 8, device=cuda, generator=gen)
        return torch.randn((1, 4, 2, 8), device=cuda, generator=gen), flat[1:].view(1, 6, 2, 8)
    if case == "strides":     # row and head strides of 9 floats
        k = torch.randn((1, 6, 2, 9), device=cuda, generator=gen)[..., :8]
        return torch.randn((1, 4, 2, 8), device=cuda, generator=gen), k
    D, Tq, Tk = {"D6 split": (6, 5, 33), "D127 split": (127, 3, 70),
                 "D127": (127, 3, 20)}[case]
    q = torch.randn((1, Tq, 1, D), device=cuda, generator=gen)
    return q, torch.randn((1, Tk, 1, D), device=cuda, generator=gen)


@pytest.mark.parametrize("case", ["base", "strides", "D6 split", "D127 split", "D127"])
def test_k3_takes_unaligned_views_through_4_byte_copies(cuda, case):
    """Where k and v cannot take 16-byte copies (a base pointer or a stride
    off 16 bytes, D not a multiple of 4) the kernel copies 4 bytes at a
    time; it still launches and matches the plain version. With D odd the
    output and the split route's scratch are written float by float."""
    q, k = _unalignedViews(case, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, splits, _ = attentionPlan(q.shape[0], q.shape[2], q.shape[1], k.shape[1], sms)
    assert (splits > 1) == case.endswith("split")
    launches = flashAttention.launches
    with torch.no_grad():
        got = flashAttention(q, k, k)
        want = flashAttentionPlain(q, k, k)
    torch.cuda.synchronize()
    assert flashAttention.launches == launches + 1
    assert (got - want).abs().max().item() <= 1e-4


def test_k3_fully_masked_rows_stay_finite(cuda):
    q, k, v = (torch.randn((1, 40, 1, 32), device=cuda) for _ in range(3))
    mask = torch.zeros((40, 40), dtype=torch.int8, device=cuda)
    mask[:20] = 1
    with torch.no_grad():
        got = flashAttention(q, k, v, mask)
    assert torch.isfinite(got).all()
    want = flashAttentionPlain(q, k, v, mask)
    assert (got[:, :20] - want[:, :20]).abs().max().item() <= 1e-4


def test_k3_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.randn((1, 4, 2, 8), device=cuda)
    with pytest.raises(TypeError, match="fp32"):
        flashAttention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="outside the kernel's range"):
        big = torch.randn((1, 4, 1, 130), device=cuda)
        flashAttention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.randn((1, 4, 8, 2), device=cuda).transpose(2, 3)
        flashAttention(t, t, t)
    with pytest.raises(RuntimeError, match="no backward"):
        flashAttention(q.clone().requires_grad_(), q, q)


def _trainingModel(cuda, channel=64, m=2, k=(512, 128)):
    from mcquic_tpu_torch.models.compressor import initialize
    return initialize(Compressor(channel, m, k), torch.Generator().manual_seed(0)).to(cuda).train()


def test_k1_codes_match_plain_after_an_optimizer_step_and_a_reassign(cuda):
    """K1 keeps each codebook's norms keyed on the tensor's version: the
    optimizer's in-place update and `refreshCodebooks`' copy_ must both be
    seen, on the same codebook tensors, or K1 searches with stale norms."""
    from mcquic_tpu_torch.train.optim import getOptimizer
    from mcquic_tpu_torch.train.state import refreshCodebooks, trainableParameters
    model = _trainingModel(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    tokens = [torch.randn((2, 700, 32), device=cuda, generator=gen) for _ in range(2)]
    codebooks = [model._quantizer.codebook(i) for i in range(2)]

    def check(label):
        with exactFp32(), torch.no_grad():
            for t, c in zip(tokens, codebooks):
                launches = vqNearest.launches
                got = vqNearest(t, c.detach())
                assert vqNearest.launches == launches + 1
                assert torch.equal(got, vqEncodePlain(t, c.detach())), label

    check("fresh")
    params = trainableParameters(model)
    optimizer = getOptimizer("Adam", lambda count: 0.05, {"lr": 0.05}, params)
    optimizer.step([torch.randn(p.shape, device=cuda, generator=gen) for p in params])
    check("after an optimizer step")
    with torch.no_grad():
        for freq in model._quantizer.frequencies():
            freq[:, ::3] = 0.0
    uniforms = [torch.rand(tuple(f.shape), device=cuda, generator=gen)
                for f in model._quantizer.frequencies()]
    assert float(refreshCodebooks(model, uniforms)) > 0
    assert all(model._quantizer.codebook(i) is codebooks[i] for i in range(2))
    check("after a reassign")


def test_engine_leaves_a_training_module_as_it_was_on_the_card(cuda):
    """Validation inside the trainer: K1 and K2 run on the live training
    model, which keeps its mode and its gradients."""
    import numpy as np
    from mcquic_tpu_torch.models.engine import CompressorEngine
    model = _trainingModel(cuda, channel=32, k=(64, 32))
    before = [p.requires_grad for p in model.parameters()]
    engine = CompressorEngine(model, device=cuda)
    image = np.random.default_rng(0).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    k1, k2 = vqNearest.launches, conv3x3SubpixelThin.launches
    restored = engine.decompressImage(engine.compressImage(image))
    assert restored.shape == image.shape
    assert vqNearest.launches - k1 == 2 and conv3x3SubpixelThin.launches - k2 == 1
    assert model.training and all(m.training for m in model.modules())
    assert [p.requires_grad for p in model.parameters()] == before and any(before)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One training step from the same weights, batch and uniforms: the loss
    and the gradient norm on the card equal the CPU's to 1e-4 relative (fp32,
    TF32 off; cuDNN and the CPU sum in other orders)."""
    from mcquic_tpu_torch.loss import PSNR
    from mcquic_tpu_torch.train.optim import getOptimizer
    from mcquic_tpu_torch.train.state import makeTrainStep, trainableParameters
    cpuModel = _trainingModel(torch.device("cpu"), channel=16, k=(32, 16))
    cardModel = Compressor(16, 2, (32, 16))
    cardModel.load_state_dict(cpuModel.state_dict())
    cardModel = cardModel.to(cuda).train()
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(1)) * 2 - 1
    uniforms = []

    def draw(device):
        queue = iter(uniforms)

        def fn(shape):
            u = next(queue, None)
            if u is None:
                u = torch.rand(shape, generator=torch.Generator().manual_seed(len(uniforms)))
                uniforms.append(u)
            return u.to(device)
        return fn

    metrics = {}
    for model, device in ((cpuModel, torch.device("cpu")), (cardModel, cuda)):
        optimizer = getOptimizer("Adam", lambda count: 1e-4, {}, trainableParameters(model))
        with exactFp32():
            metrics[device.type] = makeTrainStep(model, optimizer, PSNR())(x.to(device), draw(device))
    for key in ("loss", "gradNorm"):
        cpu, card = float(metrics["cpu"][key]), float(metrics["cuda"][key])
        assert abs(card - cpu) <= 1e-4 * abs(cpu), (key, card, cpu)
    assert metrics["cuda"]["skipped"] == metrics["cpu"]["skipped"] == 0.0


def _recordedDraw(uniforms):
    """A draw that makes CPU uniforms on first use and replays them after."""
    def draw(device):
        queue = iter(uniforms)

        def fn(shape):
            u = next(queue, None)
            if u is None:
                u = torch.rand(shape, generator=torch.Generator().manual_seed(len(uniforms)))
                uniforms.append(u)
            return u.to(device)
        return fn
    return draw


def _neon(device, channel=16, k=64, size=(2, 1, 1), useRemat=True):
    from mcquic_tpu_torch.models.compressor import Neon, initialize
    model = initialize(Neon(channel, k, size, useRemat), torch.Generator().manual_seed(0))
    return model.to(device).train()


def test_k1_codes_match_plain_after_a_shared_codebook_reassign(cuda):
    """Neon's levels share one codebook; its reassignment writes it with
    copy_, which K1's norm cache must see."""
    from mcquic_tpu_torch.train.state import refreshCodebooks
    model = _neon(cuda, k=256)
    codebook = model._quantizer.codebook
    tokens = torch.randn((1, 900, 8), device=cuda, generator=torch.Generator(cuda).manual_seed(2))
    with exactFp32(), torch.no_grad():
        assert torch.equal(vqNearest(tokens, codebook.detach()), vqEncodePlain(tokens, codebook.detach()))
        for freq in model._quantizer.frequencies():
            freq[:, ::4] = 0.0
        prop = refreshCodebooks(model, [torch.rand((1, 256), device=cuda)])
        assert float(prop) > 0 and model._quantizer.codebook is codebook
        assert torch.equal(vqNearest(tokens, codebook.detach()), vqEncodePlain(tokens, codebook.detach()))


def test_neon_train_step_on_the_card_matches_the_cpu_with_and_without_remat(cuda):
    """One Neon step from the same weights, batch and uniforms: loss and
    gradient norm on the card within 1e-4 of the CPU's; remat on the card
    gives the plain pass's gradients within 1e-5."""
    from mcquic_tpu_torch.loss import PSNR
    from mcquic_tpu_torch.train.optim import Optimizer
    from mcquic_tpu_torch.train.state import makeTrainStep, trainableParameters

    class Keep(Optimizer):
        def step(self, g):
            self.kept = [t.clone() for t in g]

    x = torch.rand((2, 3, 32, 32), generator=torch.Generator().manual_seed(1)) * 2 - 1
    draw = _recordedDraw([])
    runs = {}
    for label, device, remat in (("cpu", torch.device("cpu"), True), ("card", cuda, True),
                                 ("card plain", cuda, False)):
        model = _neon(device, useRemat=remat)
        keep = Keep(trainableParameters(model), lambda count: 0.0)
        with exactFp32():
            runs[label] = (makeTrainStep(model, keep, PSNR())(x.to(device), draw(device)), keep.kept)
    for key in ("loss", "gradNorm"):
        cpu, card = float(runs["cpu"][0][key]), float(runs["card"][0][key])
        assert abs(card - cpu) <= 1e-4 * abs(cpu), (key, card, cpu)
    for a, b in zip(runs["card"][1], runs["card plain"][1]):
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())


def test_gen_train_step_launches_k1_per_level_and_no_k3(cuda):
    """The generator's step on the card: the frozen encode runs K1 once per
    level, the transformer attends through the plain version (no K3), and
    the loss equals the CPU's within 1e-4."""
    from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
    from mcquic_tpu_torch.train.genTrainer import initializeGenerator, makeGenTrainStep
    from mcquic_tpu_torch.train.optim import getOptimizer
    geometry = dict(channel=8, k=16, size=[2, 1, 1], hiddenSize=32, depth=2, nHeads=4,
                    numClasses=10)
    cpuModel = initializeGenerator(GeneratorV3SelfAttention(**geometry),
                                   torch.Generator().manual_seed(0))
    with torch.no_grad():                      # open the adaLN gates so attention counts
        for name, p in cpuModel.named_parameters():
            if "adaLN" in name or "gate" in name:
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(7)) * 0.1)
    cardModel = GeneratorV3SelfAttention(**geometry)
    cardModel.load_state_dict(cpuModel.state_dict())
    x = torch.rand((3, 3, 32, 32), generator=torch.Generator().manual_seed(1)) * 2 - 1
    y = torch.tensor([1, 4, -1])
    metrics = {}
    for model, device in ((cpuModel, torch.device("cpu")), (cardModel.to(cuda), cuda)):
        model.compressor.requires_grad_(False)
        params = [p for p in model.parameters() if p.requires_grad]
        step = makeGenTrainStep(model.train(), getOptimizer("Adam", lambda c: 1e-4, {}, params))
        k1, k3 = vqNearest.launches, flashAttention.launches
        with exactFp32():
            metrics[device.type] = step(x.to(device), y.to(device))
        launched = (vqNearest.launches - k1, flashAttention.launches - k3)
    assert launched == (3, 0)
    for key in ("loss", "gradNorm", "ceLv02"):
        cpu, card = float(metrics["cpu"][key]), float(metrics["cuda"][key])
        assert abs(card - cpu) <= 1e-4 * abs(cpu), (key, card, cpu)


def test_lpips_on_the_card_matches_the_cpu(cuda):
    from mcquic_tpu_torch.loss.lpips import makeLpipsFn, proxyModule
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(3)) * 2 - 1
    y = (x + 0.2 * torch.randn(x.shape, generator=torch.Generator().manual_seed(4))).clamp(-1, 1)
    cpu = float(makeLpipsFn(proxyModule())(y, x))
    with exactFp32():
        card = float(makeLpipsFn(proxyModule().to(cuda))(y.to(cuda), x.to(cuda)))
    assert abs(card - cpu) <= 1e-4 * abs(cpu), (card, cpu)
