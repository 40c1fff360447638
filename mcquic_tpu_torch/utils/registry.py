"""The named tables a config reaches by key (counterpart of
`mcquic_tpu/utils/registry.py`): models, optimizers, learning-rate
schedules, losses, hooks, value tuners and generators. The port's modules
fill them where they define what they register, and every lookup of a
config's key goes through `Registry.get`. A config's `externalLib` files
(`train/cli.py::registerExternal`) add keys to them, as they add keys to
the JAX package's registries.
"""
from typing import Callable, Dict


class Registry(Dict[str, Callable]):
    """A dict of key -> constructor with the JAX package's `register` and
    `get`."""

    def __init__(self, name: str):
        super().__init__()
        self._name = name

    def register(self, obj=None, *, key: str = None):
        """Register `obj` under `key` (its `__name__` by default); without
        `obj`, a decorator."""
        def do(o, k):
            k = k or getattr(o, "__name__", None)
            if k is None:
                raise ValueError(f"Cannot infer registry key for {o!r}")
            self[k] = o
            return o
        if obj is None:
            return lambda o: do(o, key)
        return do(obj, key)

    def get(self, key: str) -> Callable:
        if key not in self:
            raise KeyError(f"`{key}` not found in {self._name} registry. Available: {sorted(self)}")
        return self[key]


ModelRegistry = Registry("Model")
OptimizerRegistry = Registry("Optimizer")
LrSchedulerRegistry = Registry("LrScheduler")
LossRegistry = Registry("Loss")
HookRegistry = Registry("Hook")
ValueTunerRegistry = Registry("ValueTuner")
GeneratorRegistry = Registry("Generator")
