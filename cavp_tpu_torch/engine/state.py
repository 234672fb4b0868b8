"""Train state (``cavp_tpu/engine/state.py``).

The JAX package carries params, batch stats and optimizer state as one
pytree. Here the module and the optimizers hold their own tensors and
are updated in place; ``TrainState`` names them together with the step
count, the sound bank and the generator the step draws from.
:meth:`TrainState.state_dict` copies all of it, so a run can be taken
again from the same point.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.optim import Optimizers
from cavp_tpu_torch.models.soundbank import init_bank


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizers: Optimizers
    sound_bank: Optional[torch.Tensor]
    generator: torch.Generator

    def state_dict(self) -> dict:
        """A deep copy of everything a step changes."""
        return copy.deepcopy({
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizers": self.optimizers.state_dict(),
            "sound_bank": self.sound_bank,
            "generator": self.generator.get_state(),
        })

    def load_state_dict(self, state: dict) -> None:
        state = copy.deepcopy(state)
        self.step = state["step"]
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizers.load_state_dict(state["optimizers"])
        self.sound_bank = state["sound_bank"]
        self.generator.set_state(state["generator"])


def create_train_state(model: nn.Module, optimizers: Optimizers, config,
                       device=None) -> TrainState:
    """The state at step 0 for a model that lies on ``device`` (default:
    the CUDA card), with an empty sound bank and a generator seeded from
    ``config.seed``.

    The bank is as deep as the reference's per-worker banks together:
    each of its gpus x nodes workers keeps a ``batch_size``-deep FIFO,
    and this single bank sees the global batch (``state.py:32-40``)."""
    device = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != device.type:
        raise ValueError(f"the model lies on {p.device}, the state was asked "
                         f"for {device}")
    bank = None
    if config is not None:
        depth = config.batch_size * max(config.gpus, 1) * max(config.nodes, 1)
        bank = init_bank(config.num_classes, depth, config.audio_samples, p.device)
    seed = 0 if config is None else config.seed
    generator = torch.Generator(device=p.device).manual_seed(seed)
    return TrainState(step=0, model=model, optimizers=optimizers,
                      sound_bank=bank, generator=generator)
