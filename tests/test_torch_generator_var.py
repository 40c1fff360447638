"""The port's `GeneratorVAR` against `mcquic_tpu/models/generator_var.py`,
fp64, on a tiny geometry: depth 2, embedDim 64, 4 heads (head dim 16), Neon
channel 8, k 16, size (2, 1, 1) (32x32 images, 6 tokens in 3 levels).

Every flax leaf is numpy-seeded (`test_torch_generator.seededGeneratorFlat`)
and carried into the port by `fromJaxGeneratorParams` (the VAR map). Codes
are held bit-identical; floats to FP32_ROUNDED, 16 fp32 ulps at unit scale:
even in fp64 the JAX package rounds the attention scores and the head's
input and logits to fp32, and the port rounds at the same points.

  * `levelCausalBias` is equal.
  * The teacher-forced pass, without the condition drop and with it (the
    JAX package's drop uniforms handed to the port's `draw`): codes, logits,
    loss and per-level CE; with the drop, the greedy preview and every
    trainable parameter's gradient of the loss too.
  * `generate` gives the same codes at every level for cfg 1.5 with top-k 0,
    top-k 4 and top-p 0.9, the JAX package's Gumbel noise handed to the
    port (`jax.random.categorical` is argmax(logits + that noise), checked at
    each call), and the same restored image at top-k 0.
  * `_filterLogits` is equal on tie-free logits.

The checkpoints and the CLI: `tests/test_torch_generator_var_cli.py`.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcquic_tpu.models.generator_var as jaxVar
from mcquic_tpu_torch.models.generator_var import GeneratorVAR, filterLogits, levelCausalBias
from mcquic_tpu_torch.utils.convert import fromJaxGeneratorParams, generatorGeometry
from test_torch_generator import portGenerator, seededGeneratorFlat, unflattenTree
from test_torch_weights import flattenTree

TINY_VAR = dict(channel=8, k=16, size=(2, 1, 1), depth=2, embedDim=64, nHeads=4, numClasses=10)
FP32_ROUNDED = 16 * 2 ** -23
CLASSES = np.array([3, 7, 10])                   # 10: the null class


def _assertClose(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ROUNDED * scale, err_msg=label)


@pytest.fixture(scope="module")
def tiny():
    flat = seededGeneratorFlat(TINY_VAR, jaxClass=jaxVar.GeneratorVAR)
    module = jaxVar.GeneratorVAR(**TINY_VAR, dtype=jnp.float64)
    return module, unflattenTree(flat), portGenerator(flat, TINY_VAR, cls=GeneratorVAR), flat


def images(seed=4):
    return np.random.default_rng(seed).uniform(-1, 1, size=(3, 32, 32, 3))


def test_level_causal_bias_is_the_jax_packages():
    for patchNums in ([1, 1, 2], [1, 1, 2, 2, 4, 4, 8, 8, 16]):
        np.testing.assert_array_equal(levelCausalBias(patchNums),
                                      np.asarray(jaxVar.levelCausalBias(patchNums)))


def test_var_map_reads_every_leaf(tiny):
    _, _, model, flat = tiny
    assert generatorGeometry(flat) == {"var": True, "halving": [True, True, False], "depth": 2,
                                       "attnL2Norm": True}
    state = fromJaxGeneratorParams(flat)
    assert set(state) == set(model.state_dict())
    assert all(np.all(v != 0) for key, v in flat.items() if "freqEMA" not in key)


@contextlib.contextmanager
def recordDrop():
    """The uniforms of the JAX package's condition drop, as the traced
    arrays the jitted function returns."""
    drawn, uniform = [], jax.random.uniform

    def record(key, shape=(), *args, **kwargs):
        u = uniform(key, shape, *args, **kwargs)
        drawn.append(u)
        return u

    jax.random.uniform = record
    try:
        yield drawn
    finally:
        jax.random.uniform = uniform


@pytest.mark.parametrize("drop", [False, True], ids=["no-drop", "drop"])
def test_teacher_forced_pass_and_gradients_equal_jax(tiny, drop):
    module, variables, model, _ = tiny
    module = module.clone(condDropRate=0.5) if drop else module
    x = images()
    with jax.enable_x64(), recordDrop() as drawn:
        def loss(params):
            out = module.apply({**variables, "params": params}, jnp.asarray(x),
                               jnp.asarray(CLASSES), train=drop,
                               rngs={"gumbel": jax.random.PRNGKey(5)})
            return out[1], (out, list(drawn))
        if drop:                  # the preview and the gradients with the drop only
            (_, ((logits, lossValue, codes, restored, perLevel), drawn)), grads = jax.jit(
                jax.value_and_grad(loss, has_aux=True))(variables["params"])
        else:
            logits, lossValue, codes, perLevel = jax.jit(
                lambda params: (lambda out: (out[0], out[1], out[2], out[4]))(
                    loss(params)[1][0]))(variables["params"])
            restored, drawn = None, []
    assert len(drawn) == (1 if drop else 0)
    drawn = [np.asarray(u) for u in drawn]
    model.condDropRate = 0.5 if drop else 0.1
    model.train()
    for p in model.parameters():
        p.grad = None
    model.compressor.requires_grad_(False)
    draw = (lambda shape: torch.from_numpy(drawn[0].copy())) if drop else None
    if drop:
        assert 0 < (drawn[0] < 0.5).sum() < 3          # some conditions dropped, not all
    out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(CLASSES), draw,
                preview=drop)
    for ours, theirs in zip(out[2], codes):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs)[..., 0][:, None])
    _assertClose(out[0].detach().numpy(), logits, "logits")
    _assertClose(out[1].item(), lossValue, "loss")
    for i, (a, b) in enumerate(zip(out[4], perLevel)):
        _assertClose(a.item(), b, f"perLevel {i}")
    if not drop:
        model.compressor.requires_grad_(True)
        return
    _assertClose(out[3].permute(0, 2, 3, 1).numpy(), restored, "restored")
    out[1].backward()
    from mcquic_tpu_torch.utils.convert import _invertMap, generatorMapOf
    state = {k: v for k, v in model.state_dict().items()}
    ourGrads = _invertMap(generatorMapOf(generatorGeometry(flattenTree(
        {"params": variables["params"], "coder": variables["coder"]}))),
        {**state, **{k: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for k, p in model.named_parameters()}})
    theirGrads = flattenTree({"params": grads})
    checked = 0
    for key, g in theirGrads.items():
        if key.startswith("params/compressor/"):
            continue
        _assertClose(ourGrads[key], g, key)
        checked += 1
    assert checked == 10 + 2 * 11            # the embeddings, tables and head; two blocks
    model.compressor.requires_grad_(True)


def categoricalWithNoise(key, logits, axis=-1):
    """argmax(logits + jax.random.gumbel(key, logits.shape)), and the noise."""
    g = jax.random.gumbel(key, logits.shape, logits.dtype)
    return jnp.argmax(logits + g, axis), g


def test_categorical_is_argmax_of_logits_plus_its_gumbel_noise():
    logits = jax.random.normal(jax.random.PRNGKey(0), (3, 5, 16))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(categoricalWithNoise(key, logits)[0],
                                      jax.random.categorical(key, logits))


@contextlib.contextmanager
def recordGumbel():
    """`jax.random.categorical` replaced by `categoricalWithNoise` (the same
    function, `test_categorical_is_argmax_of_logits_plus_its_gumbel_noise`),
    its noise kept as the traced arrays the jitted function returns."""
    noises, categorical = [], jax.random.categorical

    def record(key, logits, axis=-1):
        out, g = categoricalWithNoise(key, logits, axis)
        noises.append(g)
        return out

    jax.random.categorical = record
    try:
        yield noises
    finally:
        jax.random.categorical = categorical


@pytest.mark.parametrize("topK,topP", [(0, 0.0), (4, 0.0), (0, 0.9)])
def test_generate_gives_jax_codes_with_jax_gumbel_noise(tiny, topK, topP):
    """The codes at every level; the restored image once (top-k 0), the
    other cases leave the JAX decode out of the compiled function."""
    module, variables, model, _ = tiny
    condition = np.array([1, 4, 9])
    decode = not topK and not topP
    with jax.enable_x64(), recordGumbel() as noises:
        def run(v, c):
            codes, restored = module.apply(v, c, jax.random.PRNGKey(7), cfg=1.5, topK=topK,
                                           topP=topP, method=module.generate)
            return codes, restored if decode else None, list(noises)
        codes, restored, noises = jax.jit(run)(variables, jnp.asarray(condition))
    assert len(noises) == 3
    queue = [np.asarray(g) for g in noises]
    ours, ourRestored = model.eval().generate(
        torch.from_numpy(condition), cfg=1.5, topK=topK, topP=topP,
        gumbel=lambda shape: torch.from_numpy(queue.pop(0).copy()))
    assert not queue
    for level, (a, b) in enumerate(zip(ours, codes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[..., 0][:, None],
                                      err_msg=f"level {level}")
    if decode:
        _assertClose(ourRestored.permute(0, 2, 3, 1).numpy(), restored, "restored")


def test_filter_logits_is_the_jax_packages():
    logits = np.random.default_rng(3).permutation(96).reshape(2, 3, 16).astype(np.float32) / 7
    for topK, topP in ((0, 0.0), (4, 0.0), (0, 0.9), (4, 0.5), (1, 0.3)):
        want = np.asarray(jaxVar.GeneratorVAR._filterLogits(jnp.asarray(logits), topK, topP))
        got = filterLogits(torch.from_numpy(logits), topK, topP).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"topK {topK} topP {topP}")
