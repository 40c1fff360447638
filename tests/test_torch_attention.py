"""K3's plain version (`mcquic_tpu_torch/ops/attention.py::flashAttentionPlain`)
against the JAX package's Pallas flash attention
(`mcquic_tpu/ops/attention_pallas.py::flashAttention`), which runs in
interpret mode on the CPU, on the same numpy-seeded fp32 inputs.

Tolerance: 1e-5 abs in fp32. Both compute fp32 scores and an fp32 softmax;
the Pallas kernel accumulates P.V tile by tile and divides at the end, the
plain version normalizes first, so they differ by fp32 rounding only.

K3's launch plan (`attentionPlan`), the plain form of its split route
(`attentionPartialPlain` + `mergePartialsPlain`) and a CPU emulation of its
3xTF32 products are checked here too; the kernel itself runs only on a
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from mcquic_tpu.ops.attention_pallas import flashAttention as jaxFlashAttention
from mcquic_tpu_torch.models.generator import blockCausalMask
from mcquic_tpu_torch.ops.attention import (attentionPartialPlain, flashAttentionPlain,
                                            mergePartialsPlain)
from mcquic_tpu_torch.ops.attention_cuda import KEY_TILE, attentionPlan, flashAttention

ATOL = 1e-5
SHAPES = [(1, 2), (16, 42), (40, 130)]       # (tq, tk), none a multiple of 128


def _inputs(tq, tk, b=2, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)]


def _both(q, k, v, mask=None):
    want = np.asarray(jaxFlashAttention(q, k, v, mask=mask))
    with torch.no_grad():
        got = flashAttentionPlain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  None if mask is None else torch.from_numpy(mask))
    return want, got.numpy()


@pytest.mark.parametrize("tq,tk", SHAPES)
def test_maskless_matches_the_pallas_kernel(tq, tk):
    want, got = _both(*_inputs(tq, tk, d=64 if tq == 16 else 8))
    assert got.shape == want.shape == (2, tq, 4, 64 if tq == 16 else 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("lengths", [[1, 1, 4, 4, 16, 16], [4, 16, 20]])
def test_block_causal_mask_matches_the_pallas_kernel(lengths):
    t = sum(lengths)
    mask = blockCausalMask(lengths).astype(np.int8)
    want, got = _both(*_inputs(t, t, seed=t), mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_prefix_rows_against_a_longer_key_set():
    """The KV-cached shape: a level's queries against the whole prefix."""
    q, _, _ = _inputs(16, 16, seed=3)
    _, k, v = _inputs(42, 42, seed=4)
    want, got = _both(q, k, v)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_fully_masked_rows_stay_finite():
    q, k, v = _inputs(40, 40, h=1, seed=5)
    mask = np.zeros((40, 40), np.int8)
    mask[:20] = 1
    _, got = _both(q, k, v, mask)
    assert np.isfinite(got).all()


def test_wrapper_runs_the_plain_version_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(16, 42, seed=6))
    mask = torch.from_numpy(np.tril(np.ones((16, 42), np.int8), 26))
    launches = flashAttention.launches
    with torch.no_grad():
        for m in (None, mask):
            assert torch.equal(flashAttention(q, k, v, m), flashAttentionPlain(q, k, v, m))
    assert flashAttention.launches == launches      # counts kernel launches only


def test_wrapper_refuses_a_gradient():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 6, seed=7))
    with pytest.raises(RuntimeError, match="no backward"):
        flashAttention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert flashAttention(q, k, v).shape == (2, 4, 4, 8)


def test_mask_uses_the_additive_form_on_rows_with_a_visible_key():
    """(m - 1) * 1e9 added and -1e9 substituted (the generator's einsum path)
    give the same softmax wherever a row sees a key."""
    q, k, v = (torch.from_numpy(a).double() for a in _inputs(20, 20, seed=8))
    mask = torch.from_numpy(blockCausalMask([4, 16]))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1 / np.sqrt(8))
    probs = torch.softmax(torch.where(mask.bool(), scores, torch.full_like(scores, -1e9)), -1)
    want = torch.einsum("bhqk,bkhd->bqhd", probs.double(), v)
    torch.testing.assert_close(flashAttentionPlain(q, k, v, mask), want, rtol=0, atol=1e-15)


GEN_LENGTHS = [1, 1, 4, 4, 16, 16, 64, 64, 256]      # gen_stage2_neonA's 9 levels, 426 tokens
GEN_CALLS = [(hw, sum(GEN_LENGTHS[:i + 1])) for i, hw in enumerate(GEN_LENGTHS)] + [(426, 426)]
K3_ATOL = 1e-4                                       # chip_smoke.py's tolerance for the kernel


@pytest.mark.parametrize("B,H,Tq,Tk", [(4, 8, tq, tk) for tq, tk in GEN_CALLS]
                         + [(1, 1, 1, 1), (2, 4, 40, 130), (1, 2, 33, 7), (3, 1, 17, 65),
                            (1, 1, 500, 3000), (64, 16, 16, 42)])
def test_k3_plan_covers_every_row_and_key_once(B, H, Tq, Tk):
    warps, splits, perSplit = attentionPlan(B, H, Tq, Tk, 132)
    assert warps in (1, 2, 4) and perSplit % KEY_TILE == 0
    rows = 16 * warps
    assert warps == 1 or rows <= -(-Tq // 16) * 16           # no warp without a row tile
    assert (splits - 1) * perSplit < Tk <= splits * perSplit  # keys once each, no empty split
    qTiles = -(-Tq // rows)
    assert (qTiles - 1) * rows < Tq <= qTiles * rows         # rows once each
    blocks = qTiles * B * H * splits
    if Tq >= 64 and B * H == 32:
        assert blocks >= 132                                 # a full wave at the big levels


def _splitPartials(q, k, v, mask, bounds, scale=None):
    return [attentionPartialPlain(q, k[:, a:b], v[:, a:b],
                                  None if mask is None else mask[:, a:b], scale)
            for a, b in zip(bounds[:-1], bounds[1:])]


@pytest.mark.parametrize("tq,tk,bounds,masked", [
    (16, 42, [0, 32, 42], False),
    (4, 10, [0, 1, 3, 10], False),
    (40, 130, [0, 7, 64, 100, 130], False),
    (20, 20, [0, 4, 20], True),
    (24, 24, [0, 5, 6, 24], True),
])
def test_split_merge_equals_the_plain_version_in_fp64(tq, tk, bounds, masked):
    """Exact in fp64 against softmax attention; the plain version itself is
    off by its fp32 rounding of scores and probabilities."""
    q, k, v = (torch.from_numpy(a).double() for a in _inputs(tq, tk, d=16, seed=tq + tk))
    mask = torch.from_numpy(blockCausalMask([4, tq - 4])) if masked else None
    got = mergePartialsPlain(_splitPartials(q, k, v, mask, bounds))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
    if mask is not None:
        scores = scores + (mask.double() - 1.0) * 1e9
    exact = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    torch.testing.assert_close(got, exact, rtol=0, atol=1e-12)
    # the plain version rounds scores and probabilities to fp32 even in fp64
    torch.testing.assert_close(got, flashAttentionPlain(q, k, v, mask), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tq,tk,bounds", [(1, 2, [0, 1, 2]), (16, 42, [0, 32, 42]),
                                          (40, 130, [0, 33, 64, 96, 130])])
def test_split_merge_matches_the_pallas_kernel(tq, tk, bounds):
    d = 64 if tq == 16 else 8
    q, k, v = _inputs(tq, tk, d=d)
    want = np.asarray(jaxFlashAttention(q, k, v))
    got = mergePartialsPlain(_splitPartials(*(torch.from_numpy(a) for a in (q, k, v)), None,
                                            bounds))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32` rounds."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncateTf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an fp32 operand: its low 13 bits dropped."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _matmul3xTf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as K3 takes it on the tensor cores: each operand split into hi,
    rounded to TF32, and lo = x - hi, which the tensor core truncates to
    TF32; the products lo.hi + hi.lo + hi.hi, fp32 sums."""
    aHi, bHi = _tf32(a), _tf32(b)
    aLo, bLo = _truncateTf32(a - aHi), _truncateTf32(b - bHi)
    return aLo @ bHi + aHi @ bLo + aHi @ bHi


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -11,
                      3.0e-3, 1.0 + 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -1.0 - 2 ** -10,
                         float(_tf32(torch.tensor([3.0e-3]))), 1.0])
    assert torch.equal(_tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert ((_tf32(y) - y).abs() <= y.abs() * 2 ** -11).all()


def test_3xtf32_attention_at_level_8_stays_within_a_tenth_of_the_tolerance():
    """K3's error budget, before any card run: level 8 of the KV-cached
    generate (B 4, H 8, Tq 256, Tk 426, D 64), seeded q/k/v, scores and P.V
    in 3xTF32 with fp32 sums, against fp64 attention."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, t, 8, 64)).astype(np.float32))
               for t in (256, 426, 426))
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))           # [B, H, T, D]
    scores = _matmul3xTf32(qh, kh.transpose(-1, -2)) * (1 / 8)
    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    emulated = _matmul3xTf32(probs, vh) / probs.sum(-1, keepdim=True)
    exact = flashAttentionPlain(q.double(), k.double(), v.double()).permute(0, 2, 1, 3)
    err = (emulated.double() - exact).abs().max().item()
    assert err <= K3_ATOL / 10, err
    plainTf32 = (_tf32(probs) @ _tf32(vh)) / probs.sum(-1, keepdim=True)
    assert (plainTf32.double() - exact).abs().max().item() > err   # one TF32 product is worse
