"""Metrics sinks on the standard library's logging (counterpart of
`mcquic_tpu/train/logging.py`, reference `trainer.py:319-344, 430-493`,
without wandb): scalars with an EMA-smoothed loss, histogram and image
counts."""
import logging
from typing import Optional

import numpy as np

logger = logging.getLogger("mcquic_tpu_torch.metrics")


class EMATracker:
    """Display smoothing (reference validate/utils.py:15-28)."""

    def __init__(self, momentum: float = 0.9):
        self._momentum = momentum
        self._value: Optional[float] = None

    def step(self, x: float) -> float:
        x = float(x)
        self._value = x if self._value is None else self._momentum * self._value + (1 - self._momentum) * x
        return self._value


class MetricsLogger:
    def __init__(self):
        self._ema = EMATracker()

    def log(self, step: int, metrics: dict):
        if "loss" in metrics:
            metrics = dict(metrics, lossSmooth=self._ema.step(metrics["loss"]))
        logger.info("step %d %s", step, {k: round(float(v), 5) for k, v in metrics.items()
                                         if np.isscalar(v) or getattr(v, "ndim", 1) == 0})

    def histogram(self, step: int, name: str, values):
        values = np.asarray(values)
        logger.info("step %d %s: %d values in [%g, %g]", step, name, values.size,
                    values.min(), values.max())

    def images(self, step: int, name: str, images):
        logger.info("step %d %s: %d image(s)", step, name, len(images))
