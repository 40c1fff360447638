"""The training pieces of the port against the JAX package's, fp64 where the
JAX side takes it: the custom gradients, the random functions fed the JAX
package's own uniforms, the augmentation, the schedules, the optimizers'
update rules and the YAML reader.

Tolerances: the custom gradients, the drop mask, the reassignment, the code
refresh and the optimizer steps are exact or within 1e-12 (fp64, the same
operations); the augmentation within 1e-6 (fp32, pow and the sRGB curves
from other libraries' kernels); the schedules within 1e-6 of the larger of
the base lr and the value (the JAX package evaluates them in fp32, where
1 + cos near pi cancels), and their flat-line fractions equal but for
samples within that of the 1 % threshold.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mcquic_tpu.data import augment as jaxAugment
from mcquic_tpu.nn import functional as jaxF
from mcquic_tpu.ops import vq as jaxVq
from mcquic_tpu.train import lrSchedulers as jaxSchedules
from mcquic_tpu.train.optim import getOptimizer as jaxGetOptimizer
from mcquic_tpu.train.state import TrainState, refreshCodebooks as jaxRefresh
from mcquic_tpu_torch.data.augment import AugmentDraws, trainingTransform
from mcquic_tpu_torch.nn import functional as F
from mcquic_tpu_torch.ops.vq import randomDrop, reassignCodebook
from mcquic_tpu_torch.train import lrSchedulers
from mcquic_tpu_torch.train.optim import getOptimizer
from mcquic_tpu_torch.train.state import refreshCodebooks
from mcquic_tpu_torch.utils.yamlsubset import loads
from test_torch_weights import jaxVariables, portModel, randomStateDict

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.yaml"))


def _torchVjp(fn, x, g):
    x = torch.from_numpy(x).requires_grad_(True)
    fn(x).backward(torch.from_numpy(g))
    return x.grad.numpy()


def _jaxVjp(fn, x, g):
    with jax.enable_x64():
        _, vjp = jax.vjp(fn, jnp.asarray(x))
        return np.asarray(vjp(jnp.asarray(g))[0])


def _inputs(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) * scale, rng.normal(size=shape)


@pytest.mark.parametrize("name", ["lowerBound", "nonNegativeApply", "logExpMinusOne"])
def test_custom_gradients_equal_jax(name):
    x, g = _inputs((64, 9), seed=1, scale=0.5)
    if name == "logExpMinusOne":
        x = np.concatenate([np.abs(x) * 4 + 1e-3, x + 17.0])   # both sides of log((1 + eps) / eps)
        g = np.concatenate([g, g])
    ours = {"lowerBound": lambda t: F.lowerBound(t, 0.1),
            "nonNegativeApply": lambda t: F.nonNegativeApply(t, minimum=1e-4),
            "logExpMinusOne": F.logExpMinusOne}[name]
    theirs = {"lowerBound": lambda t: jaxF.lowerBound(t, jnp.asarray(0.1, t.dtype)),
              "nonNegativeApply": lambda t: jaxF.nonNegativeApply(t, minimum=1e-4),
              "logExpMinusOne": jaxF.logExpMinusOne}[name]
    with torch.no_grad():
        value = ours(torch.from_numpy(x)).numpy()
    with jax.enable_x64():
        np.testing.assert_allclose(value, np.asarray(theirs(jnp.asarray(x))), rtol=1e-12, atol=0)
    np.testing.assert_allclose(_torchVjp(ours, x, g), _jaxVjp(theirs, x, g), rtol=1e-12, atol=1e-15)


def test_msssim_distortion_value_and_gradient_equal_jax():
    """The MS-SSIM target: both packages compute it in fp32, summing in other
    orders, so value and gradient are held to 1e-5, the tolerance of
    tests/test_torch_validate.py."""
    from mcquic_tpu.loss import MsSSIM as JaxMsSSIM
    from mcquic_tpu_torch.loss import MsSSIM
    rng = np.random.default_rng(9)
    image = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    restored = np.clip(image + rng.normal(0, 0.2, image.shape), -1, 1).astype(np.float32)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    x = nchw(restored).requires_grad_(True)
    value = MsSSIM()(x, nchw(image))
    value.backward()
    theirs, grad = jax.value_and_grad(lambda r: JaxMsSSIM()(r, jnp.asarray(image)))(
        jnp.asarray(restored))
    assert abs(float(value) - float(theirs)) <= 1e-5
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 3, 1), np.asarray(grad), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(grad)).max()))


def test_gumbel_softmax_value_and_gradient_equal_jax():
    logits, g = _inputs((4, 3, 3, 2, 16), seed=2, scale=2.0)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64():
        uniforms = np.asarray(jax.random.uniform(key, logits.shape, jnp.float64))
        theirsValue = np.asarray(jaxF.gumbelSoftmax(key, jnp.asarray(logits)))
    ours = lambda t: F.gumbelSoftmax(t, torch.from_numpy(uniforms.copy()))
    with torch.no_grad():
        np.testing.assert_allclose(ours(torch.from_numpy(logits)).numpy(), theirsValue, rtol=0,
                                   atol=1e-15)
    np.testing.assert_allclose(_torchVjp(ours, logits, g),
                               _jaxVjp(lambda t: jaxF.gumbelSoftmax(key, t), logits, g),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("deadShare", [0.0, 0.3, 0.9])
def test_random_drop_equals_jax(deadShare):
    rng = np.random.default_rng(3)
    logit = rng.normal(size=(2, 4, 4, 2, 32))                  # [n, h, w, m, k]
    freq = rng.uniform(0, 1, size=(2, 32))
    freq[rng.uniform(size=freq.shape) < deadShare] = 0.0
    freq = (freq / freq.sum(-1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    uniforms = np.asarray(jax.random.uniform(key, logit.shape, jnp.float32))
    with jax.enable_x64():
        theirs = np.asarray(jaxVq.randomDrop(key, jnp.asarray(logit), jnp.asarray(freq)))
    ours = randomDrop(torch.from_numpy(logit.transpose(0, 3, 1, 2, 4).copy()),
                      torch.from_numpy(freq),
                      torch.from_numpy(uniforms.transpose(0, 3, 1, 2, 4).copy())).numpy()
    np.testing.assert_array_equal(ours, theirs.transpose(0, 3, 1, 2, 4))
    assert (theirs < -1e8).any() or deadShare == 0.9


def _deadFrequencies(rng, m, k, deadShare):
    freq = rng.uniform(0.1, 1, size=(m, k))
    freq[:, rng.permutation(k)[:int(deadShare * k)]] = 0.0
    return freq / freq.sum(-1, keepdims=True)


@pytest.mark.parametrize("deadShare", [0.0, 0.25, 0.75])
def test_reassign_codebook_equals_jax(deadShare):
    """More than half dead (0.75) takes the random half-codebook subset."""
    rng = np.random.default_rng(4)
    m, k, d = 2, 32, 4
    codebook = rng.normal(size=(m, k, d))
    freq = _deadFrequencies(rng, m, k, deadShare)
    key = jax.random.PRNGKey(13)
    with jax.enable_x64():
        uniforms = np.stack([np.asarray(jax.random.uniform(sub, (k,)))
                             for sub in jax.random.split(key, m)])
        theirs, theirProp = jaxVq.reassignCodebook(key, jnp.asarray(codebook), jnp.asarray(freq))
    ours, prop = reassignCodebook(torch.from_numpy(codebook), torch.from_numpy(freq),
                                  torch.from_numpy(uniforms))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert float(prop) == float(theirProp)
    assert (float(prop) > 0) == (deadShare > 0)


def test_refresh_codebooks_equals_jax():
    """Every level of a Compressor from the same state and the same keys."""
    geometry = {"channel": 8, "m": 2, "k": [16, 8]}
    stateDict = randomStateDict(**geometry, seed=6)
    rng = np.random.default_rng(6)
    for level, share in enumerate((0.75, 0.25)):
        key = f"_quantizer._entropyCoder._freqEMA.{level}"
        stateDict[key] = _deadFrequencies(rng, 2, geometry["k"][level], share) * 3.0
    variables = jaxVariables(stateDict, **geometry)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       coder=variables["coder"], optState=(), rng=jax.random.PRNGKey(21))
    with jax.enable_x64():
        newState, theirProp = jaxRefresh(state, None)
        # the keys refreshCodebooks splits off, level by level
        _, sub = jax.random.split(state.rng)
        uniforms = []
        for k in geometry["k"]:
            sub, use = jax.random.split(sub)
            uniforms.append(torch.from_numpy(np.stack(
                [np.asarray(jax.random.uniform(g, (k,))) for g in jax.random.split(use, 2)])))
    model = portModel(stateDict, **geometry)
    codebooks = [model._quantizer.codebook(i) for i in range(2)]
    versions = [c._version for c in codebooks]
    prop = refreshCodebooks(model, uniforms)
    for level in range(2):
        assert model._quantizer.codebook(level) is codebooks[level]
        assert codebooks[level]._version > versions[level]          # K1's norm cache sees it
        np.testing.assert_array_equal(codebooks[level].detach().numpy(),
                                      np.asarray(newState.params["_quantizer"][f"codebook{level}"]))
    assert abs(float(prop) - float(theirProp)) < 1e-12 and float(prop) > 0


def _jaxDraws(key, n):
    """The values the JAX package's trainingTransform draws from `key`."""
    k1, k2, k3 = jax.random.split(key, 3)
    kChoice, kGamma = jax.random.split(k1)
    kApply, kPick = jax.random.split(k2)
    kH, kV = jax.random.split(k3)
    values = lambda a: torch.from_numpy(np.array(a).ravel())
    return AugmentDraws(int(jax.random.randint(kChoice, (), 0, 4)),
                        float(jax.random.uniform(kGamma, ())),
                        values(jax.random.uniform(kApply, (n,))),
                        values(jax.random.randint(kPick, (n,), 0, 48)).long(),
                        values(jax.random.uniform(kH, (n, 1, 1, 1))),
                        values(jax.random.uniform(kV, (n, 1, 1, 1))))


def test_training_transform_equals_jax_on_every_gamma_branch():
    batch = np.random.default_rng(7).integers(0, 256, size=(4, 16, 24, 3), dtype=np.uint8)
    seen = set()
    for seed in range(40):
        if len(seen) == 4 and seed >= 8:
            break
        key = jax.random.PRNGKey(seed)
        draws = _jaxDraws(key, batch.shape[0])
        seen.add(draws.gammaChoice)
        theirs = np.asarray(jaxAugment.trainingTransform(key, jnp.asarray(batch)))
        ours = trainingTransform(torch.from_numpy(batch), draws)
        assert ours.dtype == torch.float32 and tuple(ours.shape) == (4, 3, 16, 24)
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), theirs, rtol=0, atol=1e-6,
                                   err_msg=f"seed {seed}, gamma branch {draws.gammaChoice}")
    assert seen == {0, 1, 2, 3}


SCHEDULES = [
    ("Placeholder", {}),
    ("MultiStepLRWithWarmUp", {"milestones": [10, 30, 60], "gamma": 0.5}),
    ("CyclicLR", {"max_lr": 1e-3, "step_size_up": 7, "step_size_down": 5}),
    ("CyclicLR", {"step_size_up": 6, "mode": "triangular2"}),
    ("CyclicLR", {"step_size_up": 6, "mode": "exp_range", "gamma": 0.99}),
    ("CosineAnnealingWarmupRestarts", {"first_cycle_steps": 40, "warmup_steps": 5,
                                       "lrScaleRatio": 0.001}),
    ("CosineAnnealingWarmupRestarts", {"first_cycle_steps": 20, "warmup_steps": 3,
                                       "gamma": 0.5, "lrScaleRatio": 0.01}),
    ("CosineAnnealingWarmupRestarts", {"first_cycle_steps": 10, "cycle_mult": 2.0,
                                       "warmup_steps": 2}),
]


@pytest.mark.parametrize("key,params", SCHEDULES)
def test_schedules_equal_jax(key, params):
    baseLr = 3.5355339e-05
    ours = lrSchedulers.getSchedule(key, baseLr, params)
    theirs = jaxSchedules.getSchedule(key, baseLr, params)
    for step in [0, 1, 2, 3, 5, 7, 9, 10, 11, 12, 19, 20, 21, 29, 30, 31, 39, 40, 41, 59, 60,
                 61, 75, 99]:
        want = float(theirs(step))
        assert abs(ours(step) - want) <= 1e-6 * max(baseLr, abs(want)), (step, ours(step), want)
    atThreshold = sum(abs(float(theirs(s)) - 0.01 * baseLr) <= 1e-6 * baseLr for s in range(80))
    assert abs(lrSchedulers.scheduleFlatlineFraction(ours, baseLr, 0, 80)
               - jaxSchedules.scheduleFlatlineFraction(theirs, baseLr, 0, 80)) <= atThreshold / 80


@pytest.mark.parametrize("key,params", [
    ("Adam", {"lr": 1e-3}), ("Adam", {"lr": 1e-3, "weight_decay": 0.1}),
    ("AdamW", {"lr": 1e-3}), ("FusedLAMB", {"lr": 1e-3, "weight_decay": 0.01, "use_nvlamb": True}),
    ("Lamb", {"lr": 1e-3}), ("SGD", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}),
    ("SGD", {"lr": 1e-2, "weight_decay": 0.01})])
def test_optimizer_steps_equal_optax(key, params):
    """Two steps from the same parameters and gradients, under a schedule."""
    rng = np.random.default_rng(8)
    shapes = [(8, 4, 3, 3), (8,), (2, 16, 4), (5, 7)]
    values = [rng.normal(size=s) for s in shapes]
    values[1][:] = 0.0                                  # LAMB's zero-norm branch
    grads = [[rng.normal(size=s) for s in shapes] for _ in range(2)]
    schedule = lambda count: 1e-3 * (1 + count)
    with jax.enable_x64():
        tx = jaxGetOptimizer(key, lambda count: 1e-3 * (1 + count), dict(params))
        tree = {str(i): jnp.asarray(v) for i, v in enumerate(values)}
        state = tx.init(tree)
        for g in grads:
            updates, state = tx.update({str(i): jnp.asarray(x) for i, x in enumerate(g)}, state,
                                       tree)
            tree = jax.tree_util.tree_map(lambda p, u: p + u, tree, updates)
    ours = [torch.from_numpy(v.copy()) for v in values]
    optimizer = getOptimizer(key, schedule, dict(params), ours)
    for g in grads:
        optimizer.step([torch.from_numpy(x) for x in g])
    assert optimizer.count == 2
    for i, p in enumerate(ours):
        np.testing.assert_allclose(p.numpy(), np.asarray(tree[str(i)]), rtol=1e-12, atol=1e-15,
                                   err_msg=f"tensor {i}")


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_equals_pyyaml(path):
    text = (ROOT / path).read_text()
    ours, theirs = loads(text), yaml.full_load(text)
    assert ours == theirs and repr(ours) == repr(theirs)


@pytest.mark.parametrize("text", [
    "a: 1e-4\nb: 1.e-4\nc: 1.0e-4\nd: -1\ne: 0x1F\nf: 017\ng: yes\nh: Off\ni: ~\nj:\nk: .inf\n",
    "a:\n- 1\n- [2, {b: 'c''d'}]\n- e: f   # comment\n  g: \"h#i\"\n- - j\n  - k\n",
    "a: {b: [1,\n  2], c: d}\nhooks:\n  - key: X\n    params:\n      freq: 3\n"])
def test_yaml_reader_equals_pyyaml_on_the_subset(text):
    assert repr(loads(text)) == repr(yaml.full_load(text))


@pytest.mark.parametrize("seed,size", [(0, 256), (3, 256), (7, 64), (11, 128)])
def test_random_resized_crop_is_pil_bilinear_within_one_level(seed, size):
    """The same draws give the same crop box as the JAX package's; the
    resize is torch's antialiased bilinear, which PIL's BILINEAR computes in
    fixed point, so a pixel may differ by one level (about 16 % do)."""
    import random
    from mcquic_tpu.data.dataset import randomResizedCrop as jaxCrop
    from mcquic_tpu_torch.data.dataset import randomResizedCrop
    from mcquic_tpu_torch.data.png import readPng
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    ours = randomResizedCrop(random.Random(seed), img, size).astype(np.int16)
    theirs = jaxCrop(random.Random(seed), img, size).astype(np.int16)
    assert ours.shape == theirs.shape == (size, size, 3)
    diff = np.abs(ours - theirs)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.25
