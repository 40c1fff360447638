"""Neon at configs/rd5/neon_v2_60k.yaml's geometry (channel 256, k 1024, nine
levels) against the JAX package, fp64 on the CPU (ROADMAP C5).

Every flax leaf is numpy-seeded (`test_torch_generator.seededLeaf`) and
carried into the port by the Neon name map, as tests/test_torch_neon.py does
at channel 8.

Even in fp64 the JAX package rounds the GDN normalizer to fp32 (ROADMAP C7).
The port rounds at the same point, but its fp32 rsqrt and sums may differ in
the last bits, so float outputs are held to FP32_ROUNDED times their largest
magnitude, and a code may differ only at a near tie: where the JAX
package's own fp32 distance gap between its code and the port's is within
what the residual's tolerance and the search's rounding can move
(`_nearTie`). Near ties are counted and printed; any other difference fails.
Each level's codes are also taken with the JAX codes of the smaller levels
behind them, so a near tie at one level does not carry into the next.

The JAX package's fp64 convolutions on the CPU are slow: its Neon encoder
alone took 317 s on a 256x256 input on an 8-core CPU. So tier-1 holds
  * the nine-level quantizer (encode and decode) on the latent a 256x256
    input gives (the JAX encoder's fp32 output, taken to fp64), and
  * the encoder and decoder stacks at full width on a 32x32 input;
and `test_neon_256_end_to_end` (`slow`) holds the whole codec on the 256x256
input: its codes on all nine levels and the restored image.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.models.compressor import Neon as JaxNeon
from mcquic_tpu.ops.vq import groupLatent, vqDequantizeCodes, vqEncode
from mcquic_tpu_torch.models.compressor import Neon
from mcquic_tpu_torch.ops.vq import groupLatent as portGroupLatent
from mcquic_tpu_torch.ops.vq import vqDequantizeCodes as portDequantize
from mcquic_tpu_torch.ops.vq import vqEncode as portVqEncode
from mcquic_tpu_torch.utils.convert import _applyMap, halvingOf, neonMap
from test_torch_generator import FP32_ROUNDED, seededLeaf, unflattenTree

NEON_V2 = dict(channel=256, k=1024, size=(16, 8, 8, 4, 4, 2, 2, 1, 1))   # neon_v2_60k.yaml
LEVELS = len(NEON_V2["size"])


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.numpy().transpose(0, 2, 3, 1)


def _assertClose(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ROUNDED * scale)


@pytest.fixture(scope="module")
def neon():
    """(JAX Neon, its seeded fp64 variables, the port's fp64 Neon)."""
    module = JaxNeon(**NEON_V2, dtype=jnp.float64)
    with jax.enable_x64():
        shapes = jax.eval_shape(lambda: module.init(
            {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
            jnp.zeros((1, 256, 256, 3))))
    rng = np.random.default_rng(17)
    flat = {"/".join(p.key for p in path): seededLeaf("/".join(p.key for p in path), leaf.shape, rng)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = Neon(**NEON_V2)
    model.load_state_dict(_applyMap(neonMap(halvingOf(NEON_V2["size"])), flat), strict=True)
    return module, unflattenTree(flat), model.double().eval().requires_grad_(False)


def _jaxQuantize(m, y):
    """The JAX package's `ResidualBackwardQuantizer.encode`
    (`mcquic_tpu/models/quantizer.py:242-260`) on Neon's latent `y`, also
    returning each level's residual: codes and residuals small -> large."""
    q = m._quantizer
    latents = []
    for enc in q._encoders:
        y = enc(y)
        latents.append(y)
    current = jnp.zeros_like(latents[-1])
    codes, residuals = [], []
    for i in reversed(range(len(q.size))):
        residual = latents[i] - current
        code = vqEncode(groupLatent(residual, 1), q._codebook)
        quantized = vqDequantizeCodes(code, q._codebook)
        codes.append(code)
        residuals.append(residual)
        current = q._backwards[i](quantized) if q._backwards[i] is not None else quantized
    return codes, residuals


def _quantize(neon, latent):
    """The JAX codes and residuals, the port's own codes, and the port's codes
    level by level with the JAX codes of the smaller levels behind them."""
    module, variables, model = neon
    with jax.enable_x64():
        codes, residuals = jax.jit(lambda v, y: module.apply(v, y, method=_jaxQuantize))(
            variables, latent)
        codes = [np.asarray(c).transpose(0, 3, 1, 2) for c in codes]
        residuals = [np.asarray(r) for r in residuals]
    q = model._quantizer
    with torch.no_grad():
        y = _nchw(latent)
        own = [c.numpy() for c in q.encode(y)]
        latents = []
        for enc in q._encoders:
            y = enc(y)
            latents.append(y)
        current = torch.zeros_like(latents[-1])
        forced = []
        for row, i in enumerate(reversed(range(LEVELS))):
            forced.append(portVqEncode(portGroupLatent(latents[i] - current, 1), q.codebook).numpy())
            current = q._backwards[i](portDequantize(torch.from_numpy(codes[row].copy()),
                                                     q.codebook))
    return codes, residuals, own, forced, q.codebook.numpy()[0]


def _nearTie(residual, codebook, best, chosen):
    """Whether the port's `chosen` codeword may stand for the JAX package's
    `best` for one residual token: the JAX search's fp32 distance gap
    between them (`mcquic_tpu/ops/vq.py:151-155`) is no more than what a
    residual moved by FP32_ROUNDED times the level's largest magnitude per
    coordinate can close, plus 2^-20 of the terms for the search's own
    rounding."""
    x, c = residual.astype(np.float32), codebook.astype(np.float32)
    tol = FP32_ROUNDED * max(1.0, float(np.abs(residual).max()))
    dist = lambda j: float(np.sum(c[j] * c[j]) - 2 * np.dot(x, c[j]))
    gap = dist(chosen) - dist(best)
    moved = 2 * tol * float(np.abs(c[best]).sum() + np.abs(c[chosen]).sum())
    rounding = 2 ** -20 * float(np.sum(c[best] ** 2) + np.sum(c[chosen] ** 2) + 2 * np.abs(x).sum()
                                * (np.abs(c[best]).max() + np.abs(c[chosen]).max()))
    return 0 <= gap <= moved + rounding


def _assertCodesMatchButNearTies(quantized, what):
    codes, residuals, own, forced, codebook = quantized
    assert [c.shape for c in codes] == [(1, 1, s, s) for s in NEON_V2["size"][::-1]]
    nearTies = 0
    for level, (theirs, ours, residual) in enumerate(zip(codes, forced, residuals)):
        assert ours.shape == theirs.shape
        for n, _, h, w in zip(*np.nonzero(ours != theirs)):
            best, chosen = theirs[n, 0, h, w], ours[n, 0, h, w]
            assert _nearTie(residual[n, h, w], codebook, best, chosen), \
                f"level {level} ({h}, {w}): the port chose {chosen} for {best}, not a near tie"
            nearTies += 1
    print(f"Neon at neon_v2_60k's geometry, {what}: {sum(c.size for c in codes)} codes over "
          f"{LEVELS} levels, {nearTies} near ties")
    if nearTies == 0:
        for level, (a, b) in enumerate(zip(own, codes)):
            np.testing.assert_array_equal(a, b, err_msg=f"level {level}")


@pytest.fixture(scope="module")
def latent256(neon):
    """The latent [1, 32, 32, 8] of a seeded 256x256 input: the JAX encoder's
    output in fp32, taken to fp64 for both packages' quantizers."""
    module, variables, _ = neon
    image = np.random.default_rng(18).uniform(-1, 1, size=(1, 256, 256, 3)).astype(np.float32)
    module32 = module.clone(dtype=jnp.float32)
    variables32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables)
    y = jax.jit(lambda v, x: module32.apply(v, x, method=lambda m, x: m._encoder(x)))(
        variables32, image)
    return np.asarray(y, np.float64)


@pytest.fixture(scope="module")
def quantized256(neon, latent256):
    return _quantize(neon, latent256)


def test_neon_quantizer_codes_on_all_nine_levels(quantized256):
    _assertCodesMatchButNearTies(quantized256, "quantizer on a 256x256 input's latent")


def test_neon_quantizer_decode_agrees(neon, quantized256):
    module, variables, model = neon
    codes = quantized256[0]
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, c: module.apply(
            v, c, method=lambda m, c: m._quantizer.decode(c)))(
                variables, [c.transpose(0, 2, 3, 1) for c in codes]))
    with torch.no_grad():
        got = _nhwc(model._quantizer.decode([torch.from_numpy(c.copy()) for c in codes]))
    assert want.shape == (1, 32, 32, 8)
    _assertClose(got, want)


@pytest.fixture(scope="module")
def encoded32(neon):
    """The encoder stack at full width on a 32x32 input: (JAX latent, the
    port's latent), [1, 4, 4, 8] each."""
    module, variables, model = neon
    image = np.random.default_rng(19).uniform(-1, 1, size=(1, 32, 32, 3))
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, x: module.apply(
            v, x, method=lambda m, x: m._encoder(x)))(variables, image))
    with torch.no_grad():
        got = _nhwc(model._encoder(_nchw(image)))
    return want, got


def test_neon_encoder_at_full_width_agrees(encoded32):
    want, got = encoded32
    assert want.shape == (1, 4, 4, 8)
    _assertClose(got, want)


def test_neon_decoder_at_full_width_agrees(neon, encoded32):
    module, variables, model = neon
    latent = encoded32[0]
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, y: module.apply(
            v, y, method=lambda m, y: m._decoder(y)))(variables, latent))
    with torch.no_grad():
        got = _nhwc(model._decoder(_nchw(latent)))
    assert want.shape == (1, 32, 32, 3)
    _assertClose(got, want)


@pytest.mark.slow
def test_neon_256_end_to_end(neon):
    """The whole codec on a 256x256 input (about 13 minutes on an 8-core CPU,
    most of it the JAX package's fp64 convolutions): the codes of all nine
    levels, then the image restored from the JAX codes."""
    module, variables, model = neon
    image = np.random.default_rng(18).uniform(-1, 1, size=(1, 256, 256, 3))
    with jax.enable_x64():
        y = np.asarray(jax.jit(lambda v, x: module.apply(
            v, x, method=lambda m, x: m._encoder(x)))(variables, image))
    with torch.no_grad():
        _assertClose(_nhwc(model._encoder(_nchw(image))), y)
    quantized = _quantize(neon, y)
    _assertCodesMatchButNearTies(quantized, "the whole codec on a 256x256 input")
    codes = quantized[0]
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, c: module.apply(v, c, method="decode"))(
            variables, [c.transpose(0, 2, 3, 1) for c in codes]))
    with torch.no_grad():
        got = _nhwc(model.decode([torch.from_numpy(c.copy()) for c in codes]))
    assert want.shape == (1, 256, 256, 3)
    _assertClose(got, want)
