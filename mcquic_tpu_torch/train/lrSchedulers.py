"""Learning-rate schedules as pure step -> lr functions (counterpart of
`mcquic_tpu/train/lrSchedulers.py`, reference `mcquic/train/lrSchedulers.py`):
`Placeholder`, `MultiStepLRWithWarmUp`, `CyclicLR` and
`CosineAnnealingWarmupRestarts`. Each factory takes the base lr and the
config's kwargs. The JAX package evaluates them in fp32, these in fp64.
"""
import logging
import math

import numpy as np

from mcquic_tpu_torch.utils.registry import LrSchedulerRegistry

logger = logging.getLogger("mcquic_tpu_torch.train")


@LrSchedulerRegistry.register(key="Placeholder")
def placeholder(baseLr: float, **_):
    return lambda step: float(baseLr)


@LrSchedulerRegistry.register(key="MultiStepLRWithWarmUp")
def multiStepLRWithWarmUp(baseLr: float, milestones=(), gamma: float = 0.1, **_):
    """Linear warmup until the first milestone, then step decay by gamma."""
    milestones = sorted(int(m) for m in milestones)
    first = milestones[0] if milestones else 0

    def schedule(step):
        if step <= first:
            return baseLr * min(max(step / max(first, 1), 0.0), 1.0)
        return baseLr * gamma ** sum(step >= m for m in milestones)
    return schedule


@LrSchedulerRegistry.register(key="CyclicLR")
def cyclicLR(baseLr: float, max_lr: float = None, step_size_up: int = 2000,
             step_size_down: int = None, mode: str = "triangular", gamma: float = 1.0, **_):
    """Triangular cyclic lr (reference `lrSchedulers.py:71-302`)."""
    maxLr = max_lr if max_lr is not None else baseLr * 10
    down = step_size_down if step_size_down is not None else step_size_up
    total = step_size_up + down

    def schedule(step):
        cycle = math.floor(1 + step / total)
        pos = step - (cycle - 1) * total
        frac = pos / step_size_up if pos < step_size_up else 1.0 - (pos - step_size_up) / down
        scale = {"triangular2": 1.0 / 2.0 ** (cycle - 1), "exp_range": gamma ** step}.get(mode, 1.0)
        return baseLr + (maxLr - baseLr) * max(frac, 0.0) * scale
    return schedule


@LrSchedulerRegistry.register(key="CosineAnnealingWarmupRestarts")
def cosineAnnealingWarmupRestarts(baseLr: float, first_cycle_steps: int, cycle_mult: float = 1.0,
                                  lrScaleRatio: float = 0.001, warmup_steps: int = 0,
                                  gamma: float = 1.0, **_):
    """Warmup then cosine cycles with restarts (reference
    `lrSchedulers.py:306-481`): the max lr decays by gamma per cycle, the min
    lr is baseLr * lrScaleRatio."""
    minLr = baseLr * lrScaleRatio

    def schedule(step):
        if cycle_mult == 1.0:
            cycle = math.floor(step / first_cycle_steps)
            stepInCycle = step - cycle * first_cycle_steps
            cycleSteps = float(first_cycle_steps)
        else:
            ratio = step * (cycle_mult - 1) / first_cycle_steps + 1
            cycle = math.floor(math.log(max(ratio, 1.0)) / math.log(cycle_mult))
            stepInCycle = step - first_cycle_steps * (cycle_mult ** cycle - 1) / (cycle_mult - 1)
            cycleSteps = first_cycle_steps * cycle_mult ** cycle
        maxLr = baseLr * gamma ** cycle
        if stepInCycle < warmup_steps:
            return minLr + (maxLr - minLr) * stepInCycle / max(warmup_steps, 1)
        return minLr + (maxLr - minLr) * 0.5 * (1 + math.cos(
            math.pi * (stepInCycle - warmup_steps) / max(cycleSteps - warmup_steps, 1.0)))
    return schedule


def getSchedule(key: str, baseLr: float, params: dict):
    return LrSchedulerRegistry.get(key)(baseLr, **params)


def scheduleFlatlineFraction(schedule, baseLr: float, startStep: int, totalStep: int,
                             samples: int = 256) -> float:
    """The fraction of the remaining [startStep, totalStep) budget whose lr
    is below 1 % of baseLr (`lrSchedulers.py:112-131`): a cosine cycle
    shorter than the budget trains most of the run at lr ~ 0."""
    if totalStep <= startStep:
        return 0.0
    steps = np.linspace(startStep, totalStep - 1, min(samples, totalStep - startStep))
    return float(np.mean([schedule(int(s)) < 0.01 * abs(baseLr) for s in steps]))


def checkScheduleCoversBudget(schedule, baseLr: float, startStep: int, totalStep: int,
                              threshold: float = 0.25, strict: bool = False) -> bool:
    """Warn (raise when strict) when the schedule flatlines at ~0 for more
    than `threshold` of the remaining budget; True when it does not."""
    frac = scheduleFlatlineFraction(schedule, baseLr, startStep, totalStep)
    if frac <= threshold:
        return True
    msg = (f"LR schedule spends {frac:.0%} of the remaining budget "
           f"(steps {startStep}..{totalStep}) below 1% of the base lr "
           f"({baseLr:g}) — size the schedule (e.g. first_cycle_steps) to "
           "the final TotalStep, especially after a resume with a raised "
           "budget, or most of the run trains at lr~0.")
    if strict:
        raise ValueError(msg)
    logger.warning(msg)
    return False
