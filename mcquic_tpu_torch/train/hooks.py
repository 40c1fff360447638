"""Training hooks (counterpart of `mcquic_tpu/train/hooks.py`, reference
`mcquic/train/hooks.py`): phase-typed callables `(trainer, step)` built from
the config's `hooks:` list, with the built-in `CodebookReassign`.
"""
import enum
import logging
from typing import Callable, Dict, List

from mcquic_tpu_torch.utils.registry import HookRegistry

logger = logging.getLogger("mcquic_tpu_torch.hooks")


class HookType(enum.Enum):
    BeforeRunHook = "beforeRun"
    AfterRunHook = "afterRun"
    EpochStartHook = "epochStart"
    EpochFinishHook = "epochFinish"
    StepStartHook = "stepStart"
    StepFinishHook = "stepFinish"


@HookRegistry.register
class CodebookReassign:
    """Dead-codeword reassignment every `freq` steps (reference
    hooks.py:100-121), never on the terminal step: the checkpoint written
    right after would ship codebooks and frequency tables that no step has
    re-adapted (`mcquic_tpu/train/hooks.py:48-61`)."""

    hookType = HookType.StepFinishHook

    def __init__(self, freq: int = 10000):
        self._freq = max(int(freq), 1)

    def __call__(self, trainer, step: int):
        if step % self._freq != 0:
            return
        if step >= trainer.totalStep:
            logger.info("step %d: skipping codebook reassignment on the terminal step "
                        "(checkpoint ships un-readapted)", step)
            return
        prop = trainer.reassignCodebooks()
        logger.info("step %d: codebook reassigned, proportion=%.4f", step, prop)


def getAllHooks(hookConfigs) -> Dict[HookType, List[Callable]]:
    """The config's `{key, params}` hooks grouped by phase; unknown keys are
    warned about and left out (`hooks.py:64-75`)."""
    out: Dict[HookType, List[Callable]] = {t: [] for t in HookType}
    for cfg in hookConfigs or []:
        if cfg.Key not in HookRegistry:
            logger.warning("Unknown hook %s ignored", cfg.Key)
            continue
        hook = HookRegistry.get(cfg.Key)(**cfg.Params)
        out[getattr(hook, "hookType", HookType.StepFinishHook)].append(hook)
    return out
