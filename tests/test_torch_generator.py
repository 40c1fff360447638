"""The port's stage-2 generator and Neon tokenizer against the JAX package's,
fp64, on the tiny geometry of tests/test_generator.py (channel 8, k 16,
size (2, 1, 1), hidden 32, depth 2, 4 heads, 10 classes).

Every flax leaf is replaced by a numpy-seeded non-zero value (no leaf stays
at its zero init, so the self-attention reaches the logits through the adaLN
gates) and carried into the port by `fromJaxGeneratorParams`. The flax tree's
shapes come from `jax.eval_shape` of the JAX package's own init.

Codes are held bit-identical. Float outputs are held to FP32_ROUNDED: even
in fp64 the JAX package rounds some intermediates to fp32 (the GDN
normalizer, `mcquic_tpu/nn/gdn.py:53-55`; RMSNorm, `models/generator.py:60`;
attention scores and probabilities, `:119-141`; the final logits, `:262`).
The port rounds at the same points, but its fp32 exp, rsqrt and sums may
differ from XLA's in the last bits: up to 6 fp32 ulps at unit scale in this
test's run, against a bound of 16. A wrong LayerNorm epsilon (1e-5 for flax's
1e-6) moves the logits by 3e-5, well past it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.models.generator import GeneratorV3SelfAttention as JaxGenerator
from mcquic_tpu.models.generator import GeneratorV3SelfAttentionNoAda as JaxGeneratorNoAda
from mcquic_tpu.models.generator import blockCausalMask as jaxBlockCausalMask
from mcquic_tpu_torch.models.generator import (GeneratorV3SelfAttention,
                                               blockCausalMask, topKFilter)
from mcquic_tpu_torch.utils.convert import fromJaxGeneratorParams, generatorGeometry
from mcquic_tpu_torch.utils.registry import GeneratorRegistry

TINY = dict(channel=8, k=16, size=(2, 1, 1), hiddenSize=32, depth=2, nHeads=4, numClasses=10)
NEON_A = dict(channel=256, k=1024, size=(16, 8, 8, 4, 4, 2, 2, 1, 1), hiddenSize=512, depth=8,
              nHeads=8, numClasses=1000)         # configs/rd5/gen_stage2_neonA.yaml
CLASSES = np.array([3, 7, -1])                   # -1: the null class
FP32_ROUNDED = 16 * 2 ** -23            # 16 fp32 ulps at unit scale, about 1.9e-6


def unflattenTree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def seededLeaf(key, shape, rng):
    """A non-zero value for one flax leaf, at a scale that keeps the Neon
    decoder's IGDN cascade finite: convs and denses at U(+-1/sqrt(fan_in)),
    norms' scales near 1, GDN reparams near their init, gates of both signs."""
    name = key.split("/")[-1]
    if name == "kernel":
        return rng.uniform(-1, 1, shape) / np.sqrt(int(np.prod(shape[:-1])))
    if name == "bias":
        return rng.uniform(-0.1, 0.1, shape)
    if name == "beta":
        return 1 + rng.uniform(0, 0.1, shape)
    if name == "gamma":
        return np.sqrt(0.1) * np.eye(shape[-1])[None] + rng.uniform(0, 0.05, shape)
    if name in ("scale", "temperature"):
        return 1 + rng.uniform(-0.2, 0.2, shape)
    if name == "freqEMA":
        value = rng.uniform(0.1, 1, shape)
        return value / value.sum(-1, keepdims=True)
    if name == "gate":
        return rng.uniform(0.3, 1.0, shape) * rng.choice([-1, 1], shape)
    return rng.normal(size=shape) * 0.5          # codebooks, embeddings, position tables


def seededGeneratorFlat(geometry, seed=0, jaxClass=JaxGenerator, image=32):
    """Flat flax variables of a generator (`params/...`, `coder/...`), every
    leaf numpy-seeded, shapes from `jax.eval_shape` of the flax init."""
    shapes = jax.eval_shape(lambda: jaxClass(**geometry).init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, image, image, 3)), jnp.zeros((1,), jnp.int32)))
    rng = np.random.default_rng(seed)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {"/".join(p.key for p in path): seededLeaf("/".join(p.key for p in path), leaf.shape, rng)
            for path, leaf in leaves}


def portGenerator(flat, geometry, cls=GeneratorV3SelfAttention, dtype=torch.float64):
    model = cls(**{k: v for k, v in geometry.items()})
    model.load_state_dict(fromJaxGeneratorParams(flat), strict=True)
    return model.to(dtype).eval()


def jaxGenerate(module, variables, condition, kvCache):
    """Greedy codes, the restored image and every transformer call's logits."""
    def run(v, c):
        (codes, restored), state = module.apply(
            v, c, kvCache=kvCache, method=module.generate, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "transformer")
        calls = state["intermediates"]["transformer"]["__call__"]
        return codes, restored, [c[0] if isinstance(c, tuple) else c for c in calls]
    with jax.enable_x64():
        codes, restored, logits = jax.jit(run)(variables, jnp.asarray(condition))
        return ([np.asarray(c) for c in codes], np.asarray(restored),
                [np.asarray(x) for x in logits])


def portGenerate(model, condition, kvCache, generator=None, topK=0):
    logits = []
    hook = model.transformer.register_forward_hook(lambda m, i, o: logits.append(o.numpy()))
    try:
        with torch.no_grad():
            codes, restored = model.generate(torch.from_numpy(condition), generator,
                                             topK=topK, kvCache=kvCache)
    finally:
        hook.remove()
    return [c.numpy() for c in codes], restored.numpy(), logits


@pytest.fixture(scope="module")
def tiny():
    flat = seededGeneratorFlat(TINY)
    module = JaxGenerator(**TINY, dtype=jnp.float64)
    return module, unflattenTree(flat), portGenerator(flat, TINY), flat


@pytest.fixture(scope="module", params=[True, False], ids=["kvCache", "uncached"])
def generated(request, tiny):
    module, variables, model, _ = tiny
    return (request.param, jaxGenerate(module, variables, CLASSES, request.param),
            portGenerate(model, CLASSES, request.param))


def test_every_flax_leaf_is_mapped_and_non_zero(tiny):
    _, _, model, flat = tiny
    assert all(np.all(v != 0) for key, v in flat.items() if "freqEMA" not in key)
    assert generatorGeometry(flat) == {"halving": [True, True, False], "depth": 2,
                                       "useAda": True, "qkNorm": True}
    assert len(model.state_dict()) > len(flat)     # one flax leaf feeds several reference keys


def test_greedy_codes_are_bit_identical(generated):
    _, (jaxCodes, _, _), (codes, _, _) = generated
    assert [c.shape for c in codes] == [(3, 1, 1, 1), (3, 1, 1, 1), (3, 1, 2, 2)]
    for level, (ours, theirs) in enumerate(zip(codes, jaxCodes)):
        np.testing.assert_array_equal(ours, theirs.transpose(0, 3, 1, 2), err_msg=f"level {level}")


def test_per_level_logits_agree(generated):
    kvCache, (_, _, jaxLogits), (_, _, logits) = generated
    assert len(logits) == len(jaxLogits) == 3
    for level, (ours, theirs) in enumerate(zip(logits, jaxLogits)):
        assert ours.shape == theirs.shape and ours.dtype == np.float32
        assert np.abs(theirs).max() > 0.5              # the logits carry signal
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=FP32_ROUNDED,
                                   err_msg=f"level {level}")


def test_restored_image_agrees(generated):
    _, (_, jaxRestored, _), (_, restored, _) = generated
    assert restored.shape == (3, 3, 32, 32) and np.isfinite(restored).all()
    np.testing.assert_allclose(restored.transpose(0, 2, 3, 1), jaxRestored, rtol=0,
                               atol=FP32_ROUNDED)


def test_kv_cache_and_uncached_codes_are_identical(tiny):
    _, _, model, _ = tiny
    cached, restoredA, _ = portGenerate(model, CLASSES, True)
    uncached, restoredB, _ = portGenerate(model, CLASSES, False)
    for a, b in zip(cached, uncached):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(restoredA, restoredB)


def test_top_k_mask_is_the_jax_expression():
    """generator.py:484-485: kth = sort(scaled)[..., -topK]; scaled < kth -> -1e9."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 16)).astype(np.float32)
    logits[0, 0, :4] = logits[0, 0, 4]                   # ties at the threshold
    for topK in (1, 3, 5, 16):
        kth = jnp.sort(logits, -1)[..., -topK][..., None]
        want = np.asarray(jnp.where(logits < kth, -1e9, logits))
        np.testing.assert_array_equal(topKFilter(torch.from_numpy(logits), topK).numpy(), want)


def test_sampling_with_top_1_is_greedy(tiny):
    _, _, model, _ = tiny
    greedy, _, _ = portGenerate(model, CLASSES, True)
    sampled, _, _ = portGenerate(model, CLASSES, True, torch.Generator().manual_seed(3), topK=1)
    for a, b in zip(greedy, sampled):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def neonImages():
    return np.random.default_rng(4).uniform(-1, 1, size=(2, 32, 32, 3))


@pytest.fixture(scope="module")
def jaxNeonCodes(tiny, neonImages):
    module, variables, _, _ = tiny
    with jax.enable_x64():
        codes = jax.jit(lambda v, x: module.apply(
            v, x, method=lambda m, x: m.compressor.encode(x)))(variables, neonImages)
        return [np.asarray(c) for c in codes]


def test_neon_encode_codes_are_bit_identical(tiny, neonImages, jaxNeonCodes):
    _, _, model, _ = tiny
    with torch.no_grad():
        codes = model.compressor.encode(torch.from_numpy(neonImages.transpose(0, 3, 1, 2).copy()))
    assert [tuple(c.shape) for c in codes] == [(2, 1, 1, 1), (2, 1, 1, 1), (2, 1, 2, 2)]
    for level, (ours, theirs) in enumerate(zip(codes, jaxNeonCodes)):
        np.testing.assert_array_equal(ours.numpy(), theirs.transpose(0, 3, 1, 2),
                                      err_msg=f"level {level}")


def test_neon_decode_agrees(tiny, jaxNeonCodes):
    module, variables, model, _ = tiny
    with jax.enable_x64():
        want = np.asarray(jax.jit(lambda v, c: module.apply(
            v, c, method=lambda m, c: m.compressor.decode(c)))(variables, jaxNeonCodes))
    with torch.no_grad():
        got = model.compressor.decode([torch.from_numpy(c.transpose(0, 3, 1, 2).copy())
                                       for c in jaxNeonCodes]).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ROUNDED)


@pytest.mark.parametrize("lengths", [[1, 1, 4], [1, 1, 4, 4, 16, 16, 64, 64, 256]])
def test_block_causal_mask_is_equal(lengths):
    np.testing.assert_array_equal(blockCausalMask(lengths), np.asarray(jaxBlockCausalMask(lengths)))


def test_no_ada_variant_matches():
    flat = seededGeneratorFlat(TINY, seed=5, jaxClass=JaxGeneratorNoAda)
    assert not generatorGeometry(flat)["useAda"]
    module = JaxGeneratorNoAda(**TINY, dtype=jnp.float64)
    jaxCodes, jaxRestored, _ = jaxGenerate(module, unflattenTree(flat), CLASSES, False)
    model = portGenerator(flat, TINY, GeneratorRegistry.get("GeneratorV3SelfAttentionNoAda"))
    codes, restored, _ = portGenerate(model, CLASSES, True)
    for ours, theirs in zip(codes, jaxCodes):
        np.testing.assert_array_equal(ours, theirs.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(restored.transpose(0, 2, 3, 1), jaxRestored, rtol=0,
                               atol=FP32_ROUNDED)


@pytest.mark.parametrize("kvCache", [True, pytest.param(False, marks=pytest.mark.slow)])
def test_gen_stage2_neonA_geometry_matches(kvCache):
    """Full width and depth (configs/rd5/gen_stage2_neonA.yaml), batch 1:
    426 tokens over 9 levels, a 256x256 image (ROADMAP C5). The KV-cache
    case runs in tier-1; the uncached one, which recomputes every prefix,
    stays `slow`."""
    flat = seededGeneratorFlat(NEON_A, seed=6, image=256)
    module = JaxGenerator(**NEON_A, dtype=jnp.float64)
    condition = np.array([207])
    jaxCodes, jaxRestored, _ = jaxGenerate(module, unflattenTree(flat), condition, kvCache)
    codes, restored, _ = portGenerate(portGenerator(flat, NEON_A), condition, kvCache)
    assert sum(c.size for c in codes) == 426
    for level, (ours, theirs) in enumerate(zip(codes, jaxCodes)):
        np.testing.assert_array_equal(ours, theirs.transpose(0, 3, 1, 2), err_msg=f"level {level}")
    assert restored.shape == (1, 3, 256, 256) and np.isfinite(restored).all()
    np.testing.assert_allclose(restored.transpose(0, 2, 3, 1), jaxRestored, rtol=0,
                               atol=FP32_ROUNDED)


@pytest.mark.parametrize("size", [TINY["size"], NEON_A["size"], (8, 4, 4)])
def test_neon_map_inverts_the_jax_map(size):
    """`neonMap` is `buildNeonMap` read backwards, plus the stacked
    temperature and freqEMA leaves that `convertNeon` builds by hand."""
    from mcquic_tpu.utils.convert import buildNeonMap
    from mcquic_tpu_torch.utils.convert import halvingOf, neonMap
    jaxMap = {"/".join(path): torchKey
              for path, (torchKey, _) in buildNeonMap(8, 16, list(size)).entries.items()}
    ours = {flaxKey: torchKey for torchKey, (flaxKey, _) in neonMap(halvingOf(size)).entries.items()
            if not flaxKey.endswith(("temperature", "freqEMA"))}
    assert ours == jaxMap
