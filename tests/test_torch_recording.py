"""The uniforms the JAX package's training draws, recorded for the port's
parity tests, and the tests of that recording.

The JAX quantizers draw their drop and Gumbel uniforms with `jax.random`
from keys the port cannot reproduce, so the parity tests record the JAX
package's own draws and hand the same arrays to the port's `draw`.
`recordUniforms()` wraps `mcquic_tpu.models.quantizer.randomDrop` and
`gumbelSoftmax` for the length of a `with` block, and the JAX code inside
runs un-jitted (`jax.disable_jit()`): the wrapped functions are then called
eagerly and every uniform is a concrete array when it is drawn.

The earlier form recorded under `jax.jit`, fixing a slot while tracing and
filling it through the asynchronous `jax.debug.callback`. Its count of
slots assumed that every jitted call was traced anew in that process, and
its values arrived on the runtime's callback thread; both depend on what
else the test process ran before and on the machine's load. Un-jitted,
neither applies.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcquic_tpu.models.quantizer as jaxQuantizer


class Recorder:
    """The uniforms the wrapped functions drew, in program order."""

    def __init__(self):
        self.uniforms = []

    def keep(self, u):
        self.uniforms.append(np.asarray(u))      # a tracer here means a jit was not disabled

    def draw(self, first: int = 0):
        """The port's draw: the recorded arrays from `first` on, in order,
        NHWMK -> NMHWK."""
        queue = list(self.uniforms[first:])

        def draw(shape):
            u = torch.from_numpy(queue.pop(0).transpose(0, 3, 1, 2, 4).copy())
            assert tuple(u.shape) == tuple(shape)
            return u
        return draw


@contextlib.contextmanager
def recordUniforms():
    """Record every drop and Gumbel uniform the JAX quantizers draw inside
    the block, which runs with jit disabled."""
    recorder = Recorder()
    drop, gumbel = jaxQuantizer.randomDrop, jaxQuantizer.gumbelSoftmax

    def recordDrop(key, logit, freqEMA):
        recorder.keep(jax.random.uniform(key, logit.shape, jnp.float32))
        return drop(key, logit, freqEMA)

    def recordGumbel(key, logits, temperature=1.0, hard=True):
        recorder.keep(jax.random.uniform(key, logits.shape, logits.dtype))
        return gumbel(key, logits, temperature, hard)

    patch = pytest.MonkeyPatch()
    patch.setattr(jaxQuantizer, "randomDrop", recordDrop)
    patch.setattr(jaxQuantizer, "gumbelSoftmax", recordGumbel)
    try:
        with jax.disable_jit():
            yield recorder
    finally:
        patch.undo()


def _sample(key, logits, freq):
    """What a quantizer level does with its two keys: drop, then Gumbel."""
    kG, kD = jax.random.split(key)
    return jaxQuantizer._QuantizeCore.sample(kG, kD, logits, jnp.ones((1, 4, 3)),
                                              jnp.ones((1,)), freq, True)


def test_recording_survives_a_cached_trace_of_the_same_function():
    """A jitted call traced before the recording (and cached) does not hide
    the draws of a call inside it, and the values are those the un-patched
    functions draw from the same keys."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 2, 2, 1, 3)), jnp.float32)
    freq = jnp.full((1, 4), 0.25)
    key = jax.random.PRNGKey(3)
    traced = jax.jit(_sample)
    before = traced(key, x, freq)
    with recordUniforms() as recorder:
        after = _sample(key, x, freq)
        traced(key, x, freq)                   # jit is off: runs the patched functions too
    assert len(recorder.uniforms) == 4
    kG, kD = jax.random.split(key)
    np.testing.assert_array_equal(recorder.uniforms[0], jax.random.uniform(kD, (2, 2, 2, 1, 4)))
    np.testing.assert_array_equal(recorder.uniforms[1], jax.random.uniform(kG, (2, 2, 2, 1, 4)))
    np.testing.assert_array_equal(recorder.uniforms[0], recorder.uniforms[2])
    for a, b in zip(before, after):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_the_patch_is_undone_and_the_draw_hands_out_in_order():
    with recordUniforms() as recorder:
        recorder.keep(np.zeros((1, 2, 2, 1, 3)))
        recorder.keep(np.ones((1, 2, 2, 1, 3)))
    assert jaxQuantizer.randomDrop.__name__ == "randomDrop"
    assert jaxQuantizer.gumbelSoftmax.__name__ == "gumbelSoftmax"
    draw = recorder.draw()
    assert float(draw((1, 1, 2, 2, 3)).sum()) == 0.0
    assert float(draw((1, 1, 2, 2, 3)).sum()) == 12.0
    assert float(recorder.draw(1)((1, 1, 2, 2, 3)).sum()) == 12.0
