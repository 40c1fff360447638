"""A denseNorm Neon (every residual block's middle SiLU a GroupNorm) against
the JAX package's, fp64, and the paths that take one.

The geometry is channel 32, k 16, size (1, 1): flax's GroupNorm refuses 32
groups over fewer than 32 channels, and the JAX Neon's encoder and decoder
put 32 groups in their wide stages (`mcquic_tpu/models/compressor.py:228-274`),
so channel 8 does not build in either package. Two levels (one halving, the
equal pair) keep the JAX trace short; 16x16 crops of the photo. Every flax
leaf is numpy-seeded (`test_torch_generator.seededLeaf`) and carried into
the port by the denseNorm Neon map (`utils/convert.py::neonMapOf`), whose
names tests/test_torch_convert.py holds to the JAX converter's.

The JAX training pass and its gradient run in one jit with XLA's
optimizations off (compile time; the arithmetic is the same operations),
the drop and Gumbel uniforms it draws kept as traced outputs and handed to
the port's `draw`. Held: codes bit-identical; xHat, logits, the loss and every parameter's gradient within 16
fp32 ulps of their magnitude, since even in fp64 the JAX package rounds the
GDN normalizer to fp32. `encode` is the same search on the same latents
(tests/test_torch_neon.py holds it for the plain Neon).
"""
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcquic_tpu.models.quantizer as jaxQuantizer
from mcquic_tpu.models.compressor import Neon as JaxNeon
from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.models.compressor import Neon
from mcquic_tpu_torch.utils.convert import _applyMap, _invertMap, modelGeometry, neonMapOf
from test_torch_generator import FP32_ROUNDED, seededLeaf, unflattenTree

ROOT = Path(__file__).resolve().parent.parent
GEOMETRY = dict(channel=32, k=16, size=[1, 1], denseNorm=True)


def _assertClose(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ROUNDED * scale, err_msg=label)


@contextlib.contextmanager
def keptUniforms():
    """The JAX quantizers' drop and Gumbel uniforms, as traced arrays the
    jitted function returns, in the order they are drawn."""
    kept = []
    drop, gumbel = jaxQuantizer.randomDrop, jaxQuantizer.gumbelSoftmax

    def keepDrop(key, logit, freqEMA):
        kept.append(jax.random.uniform(key, logit.shape, jnp.float32))
        return drop(key, logit, freqEMA)

    def keepGumbel(key, logits, temperature=1.0, hard=True):
        kept.append(jax.random.uniform(key, logits.shape, logits.dtype))
        return gumbel(key, logits, temperature, hard)

    patch = pytest.MonkeyPatch()
    patch.setattr(jaxQuantizer, "randomDrop", keepDrop)
    patch.setattr(jaxQuantizer, "gumbelSoftmax", keepGumbel)
    optimize = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield kept
    finally:
        jax.config.update("jax_disable_most_optimizations", optimize)
        patch.undo()


@pytest.fixture(scope="module")
def run():
    size = tuple(GEOMETRY["size"])
    module = JaxNeon(channel=32, k=16, size=size, denseNorm=True, useRemat=False,
                     dtype=jnp.float64)
    # the flax names and shapes through the port's map (tracing the flax init
    # costs seconds); the JAX apply needs every one of them, and
    # tests/test_torch_convert.py holds the map to the JAX converter's
    shapes = _invertMap(neonMapOf(GEOMETRY), Neon(**GEOMETRY).state_dict())
    rng = np.random.default_rng(5)
    flat = {key: seededLeaf(key, value.shape, rng) for key, value in sorted(shapes.items())}
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    batch = (np.stack([img[100:116, 200:216], img[300:316, 500:516]]).astype(np.float64)
             / 255.0 - 0.5) * 2.0
    variables = unflattenTree(flat)
    with jax.enable_x64(), keptUniforms() as kept:
        def lossFn(params):
            (xHat, _, codes, logits), _ = module.apply(
                {"params": params, "coder": variables["coder"]}, batch, train=True,
                rngs={"gumbel": jax.random.PRNGKey(7)}, mutable=["coder"])
            loss = jnp.mean((xHat - batch) ** 2)
            return loss, (xHat, codes, logits, list(kept))
        (loss, aux), grads = jax.jit(jax.value_and_grad(lossFn, has_aux=True))(
            variables["params"])
    xHat, codes, logits, uniforms = jax.device_get(aux)
    want = dict(loss=float(loss), xHat=xHat, codes=codes, logits=logits,
                grads={f"params/{k}": v for k, v in _flat(jax.device_get(grads)).items()})

    model = Neon(**GEOMETRY, useRemat=False)
    model.load_state_dict(_applyMap(neonMapOf(GEOMETRY), flat), strict=True)
    model = model.double().train()
    queue = [np.asarray(u).transpose(0, 3, 1, 2, 4) for u in uniforms]

    def draw(shape):
        u = torch.from_numpy(queue.pop(0).copy())
        assert tuple(u.shape) == tuple(shape)
        return u
    x = torch.from_numpy(batch.transpose(0, 3, 1, 2).copy())
    ourXHat, _, ourCodes, ourLogits = model(x, draw)
    ourLoss = ((ourXHat - x) ** 2).mean()
    ourLoss.backward()
    assert not queue
    names = dict(model.named_parameters())
    gradFlat = _invertMap(neonMapOf(GEOMETRY), {   # a parameter off the loss's path: zero, as in JAX
        k: (v if k not in names else torch.zeros_like(v) if names[k].grad is None
            else names[k].grad) for k, v in model.state_dict().items()})
    ours = dict(loss=float(ourLoss), xHat=ourXHat.detach().numpy().transpose(0, 2, 3, 1),
                codes=[c.numpy() for c in ourCodes], logits=[l.detach().numpy() for l in ourLogits],
                grads={k: v for k, v in gradFlat.items() if k.startswith("params/")})
    return flat, want, ours


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def test_the_map_names_every_group_norm_and_round_trips(run):
    flat, _, _ = run
    norms = [k for k in flat if "GroupNorm_0" in k]
    assert len(norms) == 2 * sum(1 for k in flat if k.endswith("GroupNorm_0/scale")) > 100
    model = Neon(**GEOMETRY)
    state = _applyMap(neonMapOf(GEOMETRY), flat)
    model.load_state_dict(state, strict=True)
    back = _invertMap(neonMapOf(GEOMETRY), model.state_dict())
    assert back.keys() == flat.keys()
    for key, value in flat.items():         # the port's fp32 buffers round the fp64 leaves
        np.testing.assert_array_equal(back[key], value.astype(np.float32), err_msg=key)


def test_codes_are_bit_identical(run):
    _, want, ours = run
    for level, (a, b) in enumerate(zip(ours["codes"], want["codes"])):
        np.testing.assert_array_equal(a, b.transpose(0, 3, 1, 2), err_msg=f"level {level}")


def test_floats_agree(run):
    _, want, ours = run
    _assertClose(ours["xHat"], want["xHat"], "xHat")
    for level, (a, b) in enumerate(zip(ours["logits"], want["logits"])):
        _assertClose(a, b.transpose(0, 3, 1, 2, 4), f"logits level {level}")
    _assertClose(ours["loss"], want["loss"], "loss")


def test_every_gradient_agrees(run):
    _, want, ours = run
    assert ours["grads"].keys() == want["grads"].keys()
    norms = 0
    for key, value in want["grads"].items():
        _assertClose(ours["grads"][key], value, key)
        norms += "GroupNorm_0" in key and float(np.abs(value).max()) > 0
    assert norms > 50                   # the GroupNorms are on the gradient's path


def test_model_geometry_keeps_dense_norm():
    config = {"config": {"model": {"key": "Neon", "params": dict(GEOMETRY)}}}
    assert modelGeometry(config) == GEOMETRY
    del config["config"]["model"]["params"]["denseNorm"]
    assert "denseNorm" not in modelGeometry(config)
