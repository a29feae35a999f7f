"""Train state (mirrors `hyena_dna_tpu/train/state.py`).

The JAX `TrainState` is an immutable pytree threaded through a jitted step;
here the model's parameters and the optimizer's moments are updated in
place, and the state holds the model and the optimizer, which carries the
per-group schedules and the step count.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from hyena_dna_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer

    @property
    def step(self) -> int:
        """Steps applied so far."""
        return self.optimizer.count

    def apply_gradients(self) -> torch.Tensor:
        """Clip and apply the gradients in `p.grad`; returns the global
        gradient norm before the clip."""
        return self.optimizer.step()


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)
