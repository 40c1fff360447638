"""K3's plain version (`mcquic_tpu_torch/ops/attention.py::flashAttentionPlain`)
against the JAX package's Pallas flash attention
(`mcquic_tpu/ops/attention_pallas.py::flashAttention`), which runs in
interpret mode on the CPU, on the same numpy-seeded fp32 inputs.

Tolerance: 1e-5 abs in fp32. Both compute fp32 scores and an fp32 softmax;
the Pallas kernel accumulates P.V tile by tile and divides at the end, the
plain version normalizes first, so they differ by fp32 rounding only.
"""
import numpy as np
import pytest
import torch

from mcquic_tpu.ops.attention_pallas import flashAttention as jaxFlashAttention
from mcquic_tpu_torch.models.generator import blockCausalMask
from mcquic_tpu_torch.ops.attention import flashAttentionPlain
from mcquic_tpu_torch.ops.attention_cuda import flashAttention

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
