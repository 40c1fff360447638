"""Neon's training pass against the JAX package's, fp64, at channel 8, k 16,
size (2, 1, 1) (two halving levels, then the equal pair), on two 32x32
crops of the photo.

Both packages run the same numpy-seeded weights (every flax leaf of the
JAX package's init, `test_torch_generator.seededLeaf`, carried into the
port by the Neon name map). The JAX step (`train/state.py::makeTrainStep`)
runs un-jitted with its drop and Gumbel uniforms recorded
(`test_torch_recording.recordUniforms`) and handed to the port's `draw`.
Held: codes bit-identical; xHat, logits, the updated freqEMA, the loss, its
lpips slot, the gradient norm and every parameter's (clipped) gradient
within 16 fp32 ulps of their magnitude (the JAX package rounds the GDN
normalizer to fp32 even in fp64). The lpips slot gets a stand-in function
on both sides (3 mean squared error), so that its weight of 2 in the loss
is held too; LPIPS itself is held in tests/test_torch_lpips.py.

Also: the remat and plain passes give identical gradients; the shared
codebook's reassignment equals the JAX branch on the same uniforms; and
`resolveStage1Model` resolves every shipped stage-1 config as the JAX
function does (those with a `size`, e.g. configs/v5e_8.yaml,
configs/rd3/neon_tokenizer.yaml and configs/rd5/neon_v2_*.yaml, to Neon).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcquic_tpu.config import Config as JaxConfig
from mcquic_tpu.loss import PSNR as JaxPSNR
from mcquic_tpu.models.compressor import Neon as JaxNeon
from mcquic_tpu.train.state import TrainState, makeTrainStep as jaxTrainStep
from mcquic_tpu.train.state import refreshCodebooks as jaxRefresh
from mcquic_tpu.train.trainer import resolveStage1Model as jaxResolve
from mcquic_tpu_torch.config import Config
from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.loss import PSNR
from mcquic_tpu_torch.models.compressor import Neon
from mcquic_tpu_torch.train.optim import Optimizer
from mcquic_tpu_torch.train.state import codeUsage, makeTrainStep, refreshCodebooks
from mcquic_tpu_torch.train.trainer import resolveStage1Model
from mcquic_tpu_torch.utils.convert import _applyMap, _invertMap, halvingOf, neonMap
from test_torch_generator import seededLeaf, unflattenTree
from test_torch_recording import recordUniforms
from test_torch_weights import flattenTree

ROOT = Path(__file__).resolve().parent.parent
GEOMETRY = dict(channel=8, k=16, size=(2, 1, 1))
TOL = 16 * 2 ** -23
STAGE1_CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.yaml")
                        if "Generator" not in JaxConfig.load(str(p)).Model.Key)


def _assertClose(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=label)


def seededNeonFlat(seed=3):
    shapes = jax.eval_shape(lambda: JaxNeon(**GEOMETRY).init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(seed)
    return {"/".join(p.key for p in path): seededLeaf("/".join(p.key for p in path), leaf.shape, rng)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def portNeon(flat, useRemat=True):
    model = Neon(**GEOMETRY, useRemat=useRemat)
    model.load_state_dict(_applyMap(neonMap(halvingOf(GEOMETRY["size"])), flat), strict=True)
    return model.double().train()


def _batch():
    img = readPng(ROOT / "assets" / "photo_768x512.png")
    crops = np.stack([img[100:132, 200:232], img[300:332, 500:532]])
    return (crops.astype(np.float64) / 255.0 - 0.5) * 2.0


def jaxLpipsStandIn(a, b):
    return 3.0 * jnp.mean((a - b) ** 2)


def lpipsStandIn(a, b):
    return 3.0 * ((a - b) ** 2).mean()


class Keep(Optimizer):
    """Keeps the clipped gradients it is given."""

    def step(self, g):
        self.kept = [t.clone() for t in g]


def portStep(flat, batch, draw, useRemat=True):
    """(metrics, flat clipped gradients under the flax names)."""
    model = portNeon(flat, useRemat)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    keep = Keep([p for p in model.parameters() if p.requires_grad], lambda count: 0.0)
    metrics = makeTrainStep(model, keep, PSNR(), lpipsStandIn)(batch, draw)
    grads = _invertMap(neonMap(halvingOf(GEOMETRY["size"])),
                       dict(model.state_dict(), **dict(zip(names, keep.kept))))
    return metrics, grads


@pytest.fixture(scope="module")
def run():
    flat = seededNeonFlat()
    module = JaxNeon(**GEOMETRY, dtype=jnp.float64)
    variables = unflattenTree(flat)
    batch = _batch()
    tx = optax.GradientTransformation(lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
                                      lambda grads, state, params=None: (grads, grads))
    with recordUniforms() as recorder, jax.enable_x64():
        state = TrainState.create(variables, tx, jax.random.PRNGKey(7))
        _, sub, _ = jax.random.split(state.rng, 3)
        (xHat, _, codes, logits), mut = module.apply(variables, batch, train=True,
                                                     rngs={"gumbel": sub}, mutable=["coder"])
        forward = {"xHat": np.asarray(xHat), "codes": [np.asarray(c) for c in codes],
                   "logits": [np.asarray(l) for l in logits],
                   "freq": np.asarray(mut["coder"]["_quantizer"]["freqEMA"])}
        drawn = len(recorder.uniforms)
        newState, metrics = jaxTrainStep(module, tx, JaxPSNR(), jaxLpipsStandIn)(state, batch)
        grads = flattenTree(jax.device_get(newState.optState))
    assert len(recorder.uniforms) == 2 * drawn == 4 * len(GEOMETRY["size"])

    model = portNeon(flat)
    x = torch.from_numpy(batch.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        ourXHat, _, ourCodes, ourLogits = model(x, recorder.draw())
    ours = {"xHat": ourXHat.numpy().transpose(0, 2, 3, 1), "codes": [c.numpy() for c in ourCodes],
            "logits": [l.numpy() for l in ourLogits],
            "freq": np.stack([f.numpy() for f in model._quantizer.frequencies()])}
    stepMetrics, stepGrads = portStep(flat, x, recorder.draw(drawn))
    return dict(flat=flat, x=x, recorder=recorder, drawn=drawn, forward=forward, ours=ours,
                metrics={k: float(v) for k, v in metrics.items()}, stepMetrics=stepMetrics,
                grads=grads, stepGrads=stepGrads)


def test_codes_are_bit_identical(run):
    for level, (a, b) in enumerate(zip(run["ours"]["codes"], run["forward"]["codes"])):
        np.testing.assert_array_equal(a, b.transpose(0, 3, 1, 2), err_msg=f"level {level}")


def test_xhat_logits_and_freq_ema_agree(run):
    forward, ours = run["forward"], run["ours"]
    _assertClose(ours["xHat"], forward["xHat"], "xHat")
    for level, (a, b) in enumerate(zip(ours["logits"], forward["logits"])):
        _assertClose(a, b.transpose(0, 3, 1, 2, 4), f"logits {level}")
    _assertClose(ours["freq"], forward["freq"], "freqEMA")


def test_loss_lpips_slot_and_gradient_norm_agree(run):
    metrics, ours = run["metrics"], run["stepMetrics"]
    for key in ("loss", "distortion", "mse", "lpips", "gradNorm"):
        assert abs(float(ours[key]) - metrics[key]) <= TOL * max(1.0, abs(metrics[key])), key
    assert metrics["lpips"] > 0 and ours["skipped"] == metrics["skipped"] == 0.0


def test_every_parameter_gradient_agrees(run):
    grads, ours = run["grads"], run["stepGrads"]
    assert {f"params/{k}" for k in grads} == {k for k in ours if k.startswith("params/")}
    worst = 0.0
    for key, want in grads.items():
        _assertClose(ours[f"params/{key}"], want, key)
        worst = max(worst, float(np.abs(ours[f"params/{key}"] - want).max()))
    assert float(np.abs(grads["_quantizer/temperature"]).max()) > 0
    print(f"largest gradient difference {worst:.3e}")


def test_remat_and_plain_give_identical_gradients(run):
    # the fixture's step is the remat one (portStep's default), on the same draws
    rematted, rGrads = run["stepMetrics"], run["stepGrads"]
    plain, pGrads = portStep(run["flat"], run["x"], run["recorder"].draw(run["drawn"]), False)
    assert float(rematted["loss"]) == float(plain["loss"])
    for key in rGrads:
        np.testing.assert_array_equal(rGrads[key], pGrads[key], err_msg=key)


@pytest.mark.parametrize("deadShare", [0.25, 0.75])
def test_shared_codebook_reassign_equals_jax(deadShare):
    """Each level's frequencies normalized, averaged, one reassignment; more
    than half dead (0.75) takes the random half-codebook subset. fp32, as the
    JAX branch computes it."""
    flat = seededNeonFlat(seed=5)
    rng = np.random.default_rng(8)
    L, k = len(GEOMETRY["size"]), GEOMETRY["k"]
    dead = rng.permutation(k)[:int(deadShare * k)]
    freq = rng.uniform(0.1, 1, size=(L, 1, k)) * rng.uniform(1, 3, size=(L, 1, 1))
    freq[:, :, dead] = 0.0
    flat["coder/_quantizer/freqEMA"] = freq
    flat = {key: np.asarray(value, np.float32) for key, value in flat.items()}
    variables = unflattenTree(flat)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       coder=variables["coder"], optState=(), rng=jax.random.PRNGKey(21))
    with jax.enable_x64():
        newState, theirProp = jaxRefresh(state, None)
        _, sub = jax.random.split(state.rng)
        uniforms = np.asarray(jax.random.uniform(jax.random.split(sub, 1)[0], (k,)))[None]
        from mcquic_tpu.train.state import codeUsage as jaxCodeUsage
        theirUsage = float(jaxCodeUsage(state))
    model = portNeon(flat).float()
    codebook = model._quantizer.codebook
    version = codebook._version
    prop = refreshCodebooks(model, [torch.from_numpy(uniforms.copy())])
    assert model._quantizer.codebook is codebook and codebook._version > version
    np.testing.assert_array_equal(codebook.detach().numpy(),
                                  np.asarray(newState.params["_quantizer"]["codebook"]))
    assert float(prop) == float(theirProp) > 0
    assert abs(codeUsage(model) - theirUsage) < 1e-12 and theirUsage < 1


@pytest.mark.parametrize("path", STAGE1_CONFIGS)
def test_resolve_stage1_model_equals_jax(path):
    key, params = resolveStage1Model(Config.load(str(ROOT / path)))
    theirKey, theirs = jaxResolve(JaxConfig.load(str(ROOT / path)))
    assert not theirs.pop("denseNorm", False) and not theirs.pop("permutationRate", None)
    assert key == theirKey == ("Neon" if "size" in theirs else "Compressor")
    assert params == {k: (list(v) if isinstance(v, tuple) else v) for k, v in theirs.items()}


def test_neon_configs_resolve_to_neon():
    neon = [p for p in STAGE1_CONFIGS if resolveStage1Model(Config.load(str(ROOT / p)))[0] == "Neon"]
    assert {"configs/v5e_8.yaml", "configs/rd3/neon_tokenizer.yaml",
            "configs/rd5/neon_v2_60k.yaml"} <= set(neon)
