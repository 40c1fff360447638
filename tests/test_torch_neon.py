"""`Neon.residual_forward` / `residual_backward` against the JAX package's,
fp64, at a small Neon geometry (channel 8, k 16, size (4, 2, 2): a halving
level, then an equal pair), for every level.

Every flax leaf is numpy-seeded (`test_torch_generator.seededLeaf`) and
carried into the port by the Neon name map. Outputs are held to 16 fp32
ulps of their largest magnitude, as in tests/test_torch_generator.py: even
in fp64 the JAX package rounds the GDN normalizer to fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.models.compressor import Neon as JaxNeon
from mcquic_tpu_torch.models.compressor import Neon
from mcquic_tpu_torch.utils.convert import _applyMap, halvingOf, neonMap
from test_torch_generator import FP32_ROUNDED, seededLeaf, unflattenTree

GEOMETRY = dict(channel=8, k=16, size=(4, 2, 2))
LEVELS = len(GEOMETRY["size"])


@pytest.fixture(scope="module")
def pair():
    module = JaxNeon(**GEOMETRY, dtype=jnp.float64)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(11)
    flat = {"/".join(p.key for p in path): seededLeaf("/".join(p.key for p in path), leaf.shape, rng)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = Neon(**GEOMETRY)
    model.load_state_dict(_applyMap(neonMap(halvingOf(GEOMETRY["size"])), flat), strict=True)
    return module, unflattenTree(flat), model.double().eval()


def _assertClose(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ROUNDED * scale)


def _codes(n, grid, seed):
    return np.random.default_rng(seed).integers(0, GEOMETRY["k"], size=(n, grid, grid, 1))


@pytest.mark.parametrize("level", range(1, LEVELS + 1))
def test_residual_backward_matches_jax(pair, level):
    """level counts from 1, the smallest; the smallest level's backward is
    the identity."""
    module, variables, model = pair
    grid = GEOMETRY["size"][LEVELS - level]
    code = _codes(2, grid, seed=level)
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, c: module.apply(
            v, c, method=lambda m, c: m.residual_backward(c, level)))(variables, code))
    with torch.no_grad():
        got = model.residual_backward(torch.from_numpy(code.transpose(0, 3, 1, 2).copy()), level)
    _assertClose(got.numpy().transpose(0, 2, 3, 1), want)


@pytest.mark.parametrize("level", range(LEVELS))
def test_residual_forward_matches_jax(pair, level):
    """level 0 is the smallest and has no former level."""
    module, variables, model = pair
    grid = GEOMETRY["size"][LEVELS - 1 - level]
    code = _codes(2, grid, seed=10 + level)
    former = (None if level == 0 else
              np.random.default_rng(level).normal(size=(2, grid, grid, 8)))
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, c, f: module.apply(
            v, c, f, method=lambda m, c, f: m.residual_forward(c, f, level)))(variables, code, former))
    with torch.no_grad():
        got = model.residual_forward(
            torch.from_numpy(code.transpose(0, 3, 1, 2).copy()),
            None if former is None else torch.from_numpy(former.transpose(0, 3, 1, 2).copy()),
            level)
    _assertClose(got.numpy().transpose(0, 2, 3, 1), want)
