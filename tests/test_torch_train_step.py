"""The port's training pass of the v1 Compressor against the JAX package's,
fp64, at channel 8, m 2, k (16, 8), on two 64x64 crops of the photo.

Both packages run the same numpy-seeded weights (the JAX package's own
converter, then `fromJaxParams`). The JAX step (`train/state.py::makeTrainStep`)
draws its drop and Gumbel uniforms with jax.random from its keys; the test
records them, un-jitted (`test_torch_recording.recordUniforms`), and hands
the same arrays to the port's `draw`. Held:
  * codes bit-identical;
  * xHat, logits and the updated freqEMA within TOL of their magnitude;
  * the loss, the gradient norm and the (clipped) gradient of every
    parameter within TOL of the JAX step's.
TOL is 16 fp32 ulps (about 1.9e-6) of each tensor's largest magnitude:
even in fp64 the JAX package rounds the GDN normalizer to fp32
(`mcquic_tpu/nn/gdn.py:53-55`), and the gradients flow back through it.
The target is PSNR, rd_qp2's; the MS-SSIM distortion's value and gradient
are held to the JAX package's in tests/test_torch_train_functional.py.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcquic_tpu.loss import PSNR as JaxPSNR
from mcquic_tpu.models.compressor import Compressor as JaxCompressor
from mcquic_tpu.train.state import TrainState, makeTrainStep as jaxTrainStep
from mcquic_tpu_torch.data.png import readPng
from mcquic_tpu_torch.loss import PSNR
from mcquic_tpu_torch.train.optim import Optimizer
from mcquic_tpu_torch.train.state import makeTrainStep
from mcquic_tpu_torch.utils.convert import compressorMap, toJaxParams
from test_torch_recording import recordUniforms
from test_torch_weights import flattenTree, jaxVariables, portModel, randomStateDict

TINY = {"channel": 8, "m": 2, "k": [16, 8]}
TOL = 16 * 2 ** -23
PHOTO = Path(__file__).resolve().parent.parent / "assets" / "photo_768x512.png"


def _assertClose(got, want, label="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=label)


def _batch():
    img = readPng(PHOTO)
    crops = np.stack([img[100:164, 200:264], img[300:364, 500:564]])
    return (crops.astype(np.float64) / 255.0 - 0.5) * 2.0


def _jaxStep(distortion, stateDict):
    """(recorder, forward outputs, the JAX step's metrics, its clipped grads)."""
    module = JaxCompressor(channel=TINY["channel"], m=TINY["m"], k=tuple(TINY["k"]),
                           dtype=jnp.float64)
    variables = jaxVariables(stateDict, **TINY)
    batch = _batch()
    # an optimizer whose state is the clipped gradient it was given
    tx = optax.GradientTransformation(lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
                                      lambda grads, state, params=None: (grads, grads))
    with recordUniforms() as recorder, jax.enable_x64():
        state = TrainState.create(variables, tx, jax.random.PRNGKey(7))
        _, sub, _ = jax.random.split(state.rng, 3)
        (xHat, _, codes, logits), mut = module.apply(variables, batch, train=True,
                                                     rngs={"gumbel": sub}, mutable=["coder"])
        forward = {"xHat": np.asarray(xHat), "codes": [np.asarray(c) for c in codes],
                   "logits": [np.asarray(l) for l in logits],
                   "freq": flattenTree(jax.device_get(mut["coder"]))}
        drawn = len(recorder.uniforms)
        newState, metrics = jaxTrainStep(module, tx, distortion)(state, batch)
        grads = flattenTree(jax.device_get(newState.optState))
    # the step drew the same uniforms again, from the same key
    assert len(recorder.uniforms) == 2 * drawn
    for i in range(drawn):
        np.testing.assert_array_equal(recorder.uniforms[i], recorder.uniforms[drawn + i])
    return recorder, batch, forward, {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def run():
    jaxDistortion, distortion = JaxPSNR(), PSNR()
    stateDict = randomStateDict(**TINY, seed=4)
    recorder, batch, forward, metrics, grads = _jaxStep(jaxDistortion, stateDict)
    model = portModel(stateDict, **TINY).train()
    x = torch.from_numpy(batch.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        xHat, _, codes, logits = model(x, recorder.draw())
    ours = {"xHat": xHat.numpy().transpose(0, 2, 3, 1), "codes": [c.numpy() for c in codes],
            "logits": [l.numpy() for l in logits],
            "freq": [f.detach().numpy() for f in model._quantizer.frequencies()]}

    # the port's step on a fresh copy, its optimizer keeping the clipped grads
    model = portModel(stateDict, **TINY)

    class Keep(Optimizer):
        def step(self, g):
            self.kept = [t.clone() for t in g]

    params = [p for p in model.parameters() if p.requires_grad]
    keep = Keep(params, lambda count: 0.0)
    stepMetrics = makeTrainStep(model, keep, distortion)(x, recorder.draw())
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    stateDictOfGrads = dict(model.state_dict(), **dict(zip(names, keep.kept)))
    gradsFlat = toJaxParams(stateDictOfGrads, TINY)
    return forward, ours, metrics, stepMetrics, grads, gradsFlat, names, TOL


def test_codes_are_bit_identical(run):
    forward, ours = run[:2]
    for level, (a, b) in enumerate(zip(ours["codes"], forward["codes"])):
        np.testing.assert_array_equal(a, b.transpose(0, 3, 1, 2), err_msg=f"level {level}")


def test_xhat_logits_and_freq_ema_agree(run):
    forward, ours = run[:2]
    _assertClose(ours["xHat"], forward["xHat"], "xHat")
    for level, (a, b) in enumerate(zip(ours["logits"], forward["logits"])):
        _assertClose(a, b.transpose(0, 3, 1, 2, 4), f"logits {level}")
    for level, a in enumerate(ours["freq"]):
        _assertClose(a, forward["freq"][f"_quantizer/freqEMA{level}"], f"freqEMA {level}")


def test_loss_and_gradient_norm_agree(run):
    metrics, stepMetrics, tol = run[2], run[3], run[7]
    for key in ("loss", "distortion", "mse", "gradNorm"):
        assert abs(float(stepMetrics[key]) - metrics[key]) <= tol * max(1.0, abs(metrics[key])), key
    assert stepMetrics["skipped"] == metrics["skipped"] == 0.0


def test_every_parameter_gradient_agrees(run):
    grads, gradsFlat, names, tol = run[4], run[5], run[6], run[7]
    entries = compressorMap(len(TINY["k"])).entries
    assert len(names) == len(grads)
    worst = 0.0
    for name in names:
        key = entries[name][0]
        want = grads[key[len("params/"):]]
        _assertClose(gradsFlat[key], want, key, tol)
        worst = max(worst, float(np.abs(gradsFlat[key] - want).max()))
    print(f"largest gradient difference {worst:.3e}")
