"""The generator's training pass and step against the JAX package's
(`models/generator.py::GeneratorV3SelfAttention.__call__`,
`train/genTrainer.py::makeGenTrainStep`), fp64, on the tiny geometry of
tests/test_torch_generator.py (channel 8, k 16, size (2, 1, 1), hidden 32,
depth 2, 4 heads, 10 classes) and float 32x32 images.

Every flax leaf is numpy-seeded (`seededGeneratorFlat`) and carried into the
port by `fromJaxGeneratorParams`. The step takes no random draw on float
images, so the JAX step runs jitted. Held: the frozen tokenizer's codes
bit-identical; the logits, the loss, the per-level CE, the gradient norm and
every trainable parameter's clipped gradient within 16 fp32 ulps of their
magnitude (the JAX package rounds RMSNorm, attention and the logits to fp32
even in fp64). The tokenizer gets no gradient (zero in the JAX step, none in
the port's) and no update; the greedy preview decode runs only when asked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcquic_tpu.models.generator import GeneratorV3SelfAttention as JaxGenerator
from mcquic_tpu.train.genTrainer import makeGenTrainStep as jaxGenTrainStep
from mcquic_tpu.train.state import TrainState
from mcquic_tpu_torch.train.genTrainer import makeGenTrainStep
from mcquic_tpu_torch.train.optim import Adam, Optimizer
from mcquic_tpu_torch.utils.convert import _invertMap, generatorMap, generatorGeometry
from test_torch_generator import TINY, portGenerator, seededGeneratorFlat, unflattenTree
from test_torch_weights import flattenTree

TOL = 16 * 2 ** -23
LABELS = np.array([3, 7, -1])


def _assertClose(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=label)


class Keep(Optimizer):
    def step(self, g):
        self.kept = [t.clone() for t in g]


def images(seed=4):
    return np.random.default_rng(seed).uniform(-1, 1, size=(3, 32, 32, 3))


def portModel(flat, remat=False):
    model = portGenerator(flat, TINY).train()
    model.remat = remat
    model.compressor.requires_grad_(False)
    return model


def portStep(flat, x, y, remat=False):
    """(metrics, flat clipped gradients of the trainable parameters)."""
    model = portModel(flat, remat)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    keep = Keep([p for p in model.parameters() if p.requires_grad], lambda count: 0.0)
    metrics = makeGenTrainStep(model, keep)(x, y)
    flatGrads = _invertMap(generatorMap(**generatorGeometry(flat)),
                           dict(model.state_dict(), **dict(zip(names, keep.kept))))
    mp = generatorMap(**generatorGeometry(flat))
    return metrics, {mp.entries[n][0]: flatGrads[mp.entries[n][0]] for n in names}


@pytest.fixture(scope="module")
def run():
    flat = seededGeneratorFlat(TINY, seed=9)
    module = JaxGenerator(**TINY, dtype=jnp.float64)
    variables = unflattenTree(flat)
    batch = images()
    tx = optax.GradientTransformation(lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
                                      lambda grads, state, params=None: (grads, grads))
    with jax.enable_x64():
        (predictions, loss, codes, restored, perLevel), _ = jax.jit(lambda v, x, c: module.apply(
            v, x, c, train=True, mutable=["coder"]))(variables, batch, LABELS)
        forward = {"logits": [np.asarray(p) for p in predictions], "loss": float(loss),
                   "codes": [np.asarray(c) for c in codes], "restored": np.asarray(restored),
                   "perLevel": [float(p) for p in perLevel]}
        state = TrainState.create(variables, tx, jax.random.PRNGKey(0))
        newState, metrics = jax.jit(jaxGenTrainStep(module, tx))(state, batch, LABELS)
        grads = flattenTree(jax.device_get(newState.optState))
    x = torch.from_numpy(batch.transpose(0, 3, 1, 2).copy())
    y = torch.from_numpy(LABELS)
    model = portModel(flat)
    with torch.no_grad():
        ourPredictions, ourLoss, ourCodes, ourRestored, ourPerLevel = model(x, y, preview=True)
    ours = {"logits": [p.numpy() for p in ourPredictions], "loss": float(ourLoss),
            "codes": [c.numpy() for c in ourCodes], "restored": ourRestored.numpy(),
            "perLevel": [float(p) for p in ourPerLevel]}
    stepMetrics, stepGrads = portStep(flat, x, y)
    return dict(flat=flat, x=x, y=y, forward=forward, ours=ours, grads=grads,
                metrics={k: float(v) for k, v in metrics.items()}, stepMetrics=stepMetrics,
                stepGrads=stepGrads)


def test_frozen_encode_codes_are_bit_identical(run):
    for level, (a, b) in enumerate(zip(run["ours"]["codes"], run["forward"]["codes"])):
        np.testing.assert_array_equal(a, b.transpose(0, 3, 1, 2), err_msg=f"level {level}")


def test_logits_loss_and_per_level_ce_agree(run):
    ours, theirs = run["ours"], run["forward"]
    for level, (a, b) in enumerate(zip(ours["logits"], theirs["logits"])):
        _assertClose(a, b, f"logits {level}")
    assert abs(ours["loss"] - theirs["loss"]) <= TOL * max(1.0, abs(theirs["loss"]))
    for level, (a, b) in enumerate(zip(ours["perLevel"], theirs["perLevel"])):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), level
    _assertClose(ours["restored"].transpose(0, 2, 3, 1), theirs["restored"], "preview")


def test_step_metrics_agree(run):
    metrics, ours = run["metrics"], run["stepMetrics"]
    keys = {"loss", "gradNorm", "skipped"} | {f"ceLv{i:02d}" for i in range(len(TINY["size"]))}
    assert set(ours) == set(metrics) == keys
    for key in keys:
        assert abs(float(ours[key]) - metrics[key]) <= TOL * max(1.0, abs(metrics[key])), key
    assert metrics["skipped"] == 0.0


def test_every_trainable_gradient_agrees_and_the_tokenizer_gets_none(run):
    grads, ours = run["grads"], run["stepGrads"]
    frozen = {k for k in grads if k.startswith("compressor/")}
    assert frozen and all(not np.any(grads[k]) for k in frozen)
    assert {f"params/{k}" for k in grads} - {f"params/{k}" for k in frozen} == set(ours)
    for key, got in ours.items():
        _assertClose(got, grads[key[len("params/"):]], key)
    assert not np.any(ours["params/transformer/posEmbed"])    # stop_gradient in both


def test_the_tokenizer_stays_bit_identical_under_adam(run):
    model = portModel(run["flat"])
    before = {k: v.clone() for k, v in model.compressor.state_dict().items()}
    params = [p for p in model.parameters() if p.requires_grad]
    assert not any(p is q for p in params for q in model.compressor.parameters())
    step = makeGenTrainStep(model, Adam(params, lambda count: 1e-2))
    for _ in range(2):
        step(run["x"], run["y"])
    for key, value in model.compressor.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert not torch.equal(model.classEmbed, portModel(run["flat"]).classEmbed)


def test_preview_decodes_only_when_asked(run, monkeypatch):
    model = portModel(run["flat"])
    calls = []
    decode = model.compressor.decode
    monkeypatch.setattr(model.compressor, "decode", lambda codes: calls.append(1) or decode(codes))
    with torch.no_grad():
        assert model(run["x"], run["y"])[3] is None and not calls
        assert model(run["x"], run["y"], preview=True)[3] is not None and len(calls) == 1


def test_remat_gives_identical_gradients(run):
    plain, plainGrads = portStep(run["flat"], run["x"], run["y"], remat=False)
    rematted, rematGrads = portStep(run["flat"], run["x"], run["y"], remat=True)
    assert float(plain["loss"]) == float(rematted["loss"])
    for key in plainGrads:
        np.testing.assert_array_equal(rematGrads[key], plainGrads[key], err_msg=key)


def test_size_mismatch_is_refused(run):
    model = portModel(run["flat"])
    with pytest.raises(ValueError, match="does not match the tokenizer"):
        model(torch.zeros(1, 3, 64, 64, dtype=torch.float64), run["y"][:1])
