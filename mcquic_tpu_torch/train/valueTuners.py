"""Step-indexed scalar schedules for loss weights and temperatures
(counterpart of `mcquic_tpu/train/valueTuners.py`, reference
`mcquic/train/valueTuners.py:6-118`): CyclicValue, ExponentialValue,
StepValue, CosineValue, CosineValueWithEnd, JumpValue and JumpAlter, each a
function of the epoch (`calc`) with the reference's `.step()` / `.Value`
interface, each registered in `utils/registry.py::ValueTunerRegistry` by the JAX
package's keys.
"""
import math

from mcquic_tpu_torch.utils.registry import ValueTunerRegistry


class ValueTuner:
    """`.step()` advances an epoch counter, `.Value` reads the scalar at it."""

    def __init__(self, **kwargs):
        self._epoch = 0
        self._kwargs = kwargs

    def calc(self, epoch: int) -> float:
        raise NotImplementedError

    def step(self):
        self._epoch += 1

    @property
    def Value(self) -> float:
        return self.calc(self._epoch)


@ValueTunerRegistry.register
class CyclicValue(ValueTuner):
    def __init__(self, initValue: float = 2e-2, gamma: float = 1.0, cyclicInterval: int = 400,
                 boostInterval: int = 3, zeroOutRatio: float = 1. / 3.):
        super().__init__()
        self._initValue, self._gamma = initValue, gamma
        self._cyclicInterval, self._boostInterval = cyclicInterval, boostInterval
        self._zeroOutRatio = zeroOutRatio

    def calc(self, epoch):
        maxReg = self._initValue * (self._gamma ** epoch)
        if (epoch // self._cyclicInterval) % self._boostInterval == 0:
            return maxReg
        j = (epoch % self._cyclicInterval) / float(self._cyclicInterval)
        down = 2 * maxReg / (self._zeroOutRatio - 1) * j + maxReg
        up = (2 * maxReg / (1 - self._zeroOutRatio) * j
              + (self._zeroOutRatio + 1) / (self._zeroOutRatio - 1) * maxReg)
        return max(0.0, max(up, down))


@ValueTunerRegistry.register
class ExponentialValue(ValueTuner):
    def __init__(self, initValue: float = 2e-2, gamma: float = 0.9999):
        super().__init__()
        self._initValue, self._gamma = initValue, gamma

    def calc(self, epoch):
        return self._initValue * (self._gamma ** epoch)


@ValueTunerRegistry.register
class StepValue(ValueTuner):
    def __init__(self, initValue: float = 2e-2, gamma: float = 0.1, stepInterval: int = 1000):
        super().__init__()
        self._initValue, self._gamma, self._stepInterval = initValue, gamma, stepInterval

    def calc(self, epoch):
        return self._initValue * (self._gamma ** (epoch // self._stepInterval))


@ValueTunerRegistry.register
class CosineValue(ValueTuner):
    def __init__(self, maxValue: float = 1.0, minValue: float = 0.0, stepInterval: int = 1,
                 totalStep: int = 1000, revert: bool = False):
        super().__init__()
        self._maxValue, self._minValue = maxValue, minValue
        self._stepInterval, self._totalStep, self._revert = stepInterval, totalStep, revert

    def calc(self, epoch):
        nowCosine = math.cos(math.pi * epoch / self._stepInterval / self._totalStep)
        return (nowCosine + 1) / 2.0 * (self._maxValue - self._minValue) + self._minValue


@ValueTunerRegistry.register
class CosineValueWithEnd(CosineValue):
    def calc(self, epoch):
        if epoch / self._stepInterval / self._totalStep >= 1:
            return self._minValue
        nowCosine = math.cos(math.pi * epoch / self._stepInterval / self._totalStep)
        if self._revert:
            nowCosine = -nowCosine
        return (nowCosine + 1) / 2.0 * (self._maxValue - self._minValue) + self._minValue


@ValueTunerRegistry.register
class JumpValue(ValueTuner):
    def __init__(self, initValue: float = 10.0, gamma: float = 0.9, stepInterval: int = 1000,
                 minValue: float = 0.01):
        super().__init__()
        self._initValue, self._gamma, self._stepInterval = initValue, gamma, stepInterval
        self._iteration = int(math.log(minValue / initValue) / math.log(gamma))

    def calc(self, epoch):
        return self._initValue * (self._gamma ** ((epoch // self._stepInterval) % self._iteration))


@ValueTunerRegistry.register
class JumpAlter(JumpValue):
    def __init__(self, initValue: float = 10.0, gamma: float = 0.9, stepInterval: int = 10,
                 minValue: float = 0.01, milestone: int = 500, valueAfterMilestone: float = 0.01):
        super().__init__(initValue, gamma, stepInterval, minValue)
        self._milestone = milestone
        self._valueAfterMilestone = valueAfterMilestone

    def calc(self, epoch):
        if self._iteration <= self._milestone:
            return super().calc(epoch)
        return self._valueAfterMilestone

