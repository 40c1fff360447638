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
from mcquic_tpu_torch.ops.attention_cuda import flashAttention
from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelPlain, conv3x3SubpixelThin
from mcquic_tpu_torch.ops.vq import groupLatent, vqEncode, vqEncodePlain
from mcquic_tpu_torch.ops.vq_cuda import vqNearest
from mcquic_tpu_torch.ops.vq_grouped_cuda import vqNearestGrouped
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
                                         (1, 2, 5, 33, 6), (2, 1, 3, 70, 127)])
def test_k3_matches_plain_over_a_cache_prefix(cuda, B, H, Tq, Tk, D):
    """k and v are a prefix slice of a longer [B, Lmax, H, D] cache."""
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
