"""Host-side learning-rate and temperature schedules.

A copy of ``dalle_pytorch_tpu/utils/schedule.py`` (stdlib only), kept here
because this package never imports the JAX one:

* ``ExponentialDecay`` (gamma 0.98) for the VAE, stepped every 100 iters
  alongside the gumbel temperature anneal;
* ``ReduceLROnPlateau`` (factor 0.5, patience 5, cooldown 0, min 1e-7)
  for DALLE, stepped on the epoch-end loss;
* ``GumbelTemperature``, the VAE's compounding temperature anneal.

The train step reads the learning rate from its optimizer
(``training.set_learning_rate``), so these own the state on the host.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class ExponentialDecay:
    lr: float
    gamma: float = 0.98

    def step(self) -> float:
        self.lr *= self.gamma
        return self.lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """min-mode plateau scheduler with the semantics of
    torch.optim.lr_scheduler's (relative threshold 1e-4)."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    cooldown: int = 0
    min_lr: float = 1e-7
    threshold: float = 1e-4

    best: float = float("inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


@dataclasses.dataclass
class GumbelTemperature:
    """VAE gumbel temperature anneal: ``temp * exp(-anneal_rate * step)``
    floored at ``min_temp``, updated every 100 steps."""

    start: float = 1.0
    min_temp: float = 0.5
    anneal_rate: float = 1e-6
    value: float = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.value is None:
            self.value = self.start

    def update(self, global_step: int) -> float:
        # compounding: temp = max(temp * exp(-rate * global_step), min)
        self.value = max(self.value * math.exp(-self.anneal_rate * global_step),
                         self.min_temp)
        return self.value
