"""Train state (``cavp_tpu/engine/state.py``).

The JAX package carries params, batch stats and optimizer state as one
pytree. Here the module and the optimizers hold their own tensors and
are updated in place; ``TrainState`` names them together with the step
count, the sound bank and the generator the step draws from.
:meth:`TrainState.state_dict` copies all of it to host memory, in the
checkpoint's layout, so a run can be taken again from the same point.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn as nn

from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.optim import Optimizers
from cavp_tpu_torch.models.soundbank import init_bank


def map_tensors(fn: Callable[[torch.Tensor], Any], obj):
    """``obj`` with ``fn`` applied to every tensor in its dicts, lists and
    tuples; everything else as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def to_host(obj):
    """Host copies of every tensor in ``obj``. From the card they go into
    pinned memory by copies that do not wait, and the host waits once for
    all of them, not once a tensor; host tensors are cloned."""
    waits = []

    def copy(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        host = torch.empty_like(t, device="cpu", pin_memory=True)
        host.copy_(t, non_blocking=True)
        waits.append(t.device)
        return host

    out = map_tensors(copy, obj)
    for device in set(waits):
        torch.cuda.current_stream(device).synchronize()
    return out


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizers: Optimizers
    sound_bank: Optional[torch.Tensor]
    generator: torch.Generator

    def state_dict(self) -> dict:
        """Host copies of everything a step changes, under the checkpoint's
        keys: ``model`` (the reference's state-dict names),
        ``visual_optimizer`` (the SGD over the five scheduled groups),
        ``audio_optimizer`` (the Adam over the audio tower; ``None`` for a
        model without one), ``step``,
        ``sound_bank`` and ``generator`` (its state)."""
        return {
            "model": to_host(self.model.state_dict()),
            "visual_optimizer": to_host(self.optimizers.sgd.state_dict()),
            "audio_optimizer": (None if self.optimizers.adam is None
                                else to_host(self.optimizers.adam.state_dict())),
            "step": self.step,
            "sound_bank": None if self.sound_bank is None else to_host(self.sound_bank),
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        """Take every part of :meth:`state_dict`'s payload. The tensors are
        copied: the state never shares storage with ``state``."""
        device = next(self.model.parameters()).device

        def own(t: torch.Tensor) -> torch.Tensor:
            # the optimizers keep a tensor that already lies on their
            # parameters' device as it is, and Adam its 0-dim step counts
            # wherever they lie, and update them in place
            return t.clone() if t.device == device or t.dim() == 0 else t

        self.model.load_state_dict(state["model"], strict=True)
        self.optimizers.sgd.load_state_dict(map_tensors(own, state["visual_optimizer"]))
        if self.optimizers.adam is not None:
            self.optimizers.adam.load_state_dict(map_tensors(own, state["audio_optimizer"]))
        self.step = int(state["step"])
        bank = state["sound_bank"]
        self.sound_bank = None if bank is None else bank.to(device, copy=True)
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
