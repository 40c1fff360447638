"""Every value tuner of the port against the JAX package's, at their
defaults and at a second parameter set, over a range of epochs, both
through `calc` and through `.step()` / `.Value`."""
import pytest

from mcquic_tpu.train import valueTuners as jaxTuners
from mcquic_tpu_torch.train import valueTuners  # noqa: F401  (fills the registry)
from mcquic_tpu_torch.utils.registry import ValueTunerRegistry as VALUE_TUNERS

PARAMS = {
    "CyclicValue": {"initValue": 0.5, "gamma": 0.999, "cyclicInterval": 40, "boostInterval": 2,
                    "zeroOutRatio": 0.25},
    "ExponentialValue": {"initValue": 3.0, "gamma": 0.99},
    "StepValue": {"initValue": 1.0, "gamma": 0.5, "stepInterval": 70},
    "CosineValue": {"maxValue": 2.0, "minValue": 0.5, "stepInterval": 3, "totalStep": 90},
    "CosineValueWithEnd": {"maxValue": 2.0, "minValue": 0.5, "stepInterval": 2, "totalStep": 100,
                           "revert": True},
    "JumpValue": {"initValue": 5.0, "gamma": 0.8, "stepInterval": 30, "minValue": 0.1},
    "JumpAlter": {"initValue": 5.0, "gamma": 0.8, "stepInterval": 3, "minValue": 0.1,
                  "milestone": 10, "valueAfterMilestone": 0.2},
}
EPOCHS = [0, 1, 2, 3, 7, 10, 29, 30, 31, 99, 100, 133, 200, 399, 400, 401, 799, 800, 1000,
          1201, 2500, 5000]


@pytest.mark.parametrize("key, params", [(k, {}) for k in sorted(PARAMS)]
                         + sorted(PARAMS.items()))
def test_value_tuner_equals_jax(key, params):
    assert set(VALUE_TUNERS) == {k for k in PARAMS}
    ours, theirs = VALUE_TUNERS[key](**params), getattr(jaxTuners, key)(**params)
    for epoch in EPOCHS:
        assert ours.calc(epoch) == theirs.calc(epoch), (key, epoch)
    for _ in range(450):
        assert ours.Value == theirs.Value
        ours.step()
        theirs.step()
