"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips where torch sees no CUDA card.
This file imports only torch and the port, so it also runs on a machine
without the JAX package (tests/conftest.py imports JAX, hence
`--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from mcquic_tpu_torch.ops import subpixel_cuda, vq_cuda
from mcquic_tpu_torch.ops.subpixel_cuda import conv3x3SubpixelPlain, conv3x3SubpixelThin
from mcquic_tpu_torch.ops.vq import vqEncodePlain
from mcquic_tpu_torch.ops.vq_cuda import vqNearest
from mcquic_tpu_torch.utils import exactFp32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU form)")
    return torch.device("cuda")


def test_kernel_libraries_build(cuda):
    vq_cuda.build()
    subpixel_cuda.build()


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
