"""Optimizers: the reference's two-optimizer, multi-group structure
(``cavp_tpu/engine/optim.py``).

Six groups over the one ``CAVP`` module, by state-dict name:

- ``seg_decay`` / ``seg_nodecay``: ``segment.*``, SGD at lr x10;
- ``bkb_decay`` / ``bkb_nodecay``: ``backbone.*``, SGD at lr x1;
- ``fusion``: ``cross_att.*`` and ``visual_projector.*``, SGD at lr x1
  with weight decay on every parameter (the reference appends these as
  plain groups, so their biases and norms do decay);
- ``audio``: ``audio_backbone.*`` (the JAX package's ``audio_net``),
  Adam at a constant ``config.lr``, never scheduled.

In the ``*_decay`` groups only conv and linear weights decay (flax's
``kernel`` leaves); biases and BatchNorm affines go to ``*_nodecay``.
``torch.optim.SGD`` with ``dampening=0, nesterov=False`` is the JAX
``sgd_group`` op for op: ``g += wd*p; buf = momentum*buf + g; p -= lr*buf``,
the first step's buffer being the gradient.

The lr lag of the reference is kept (``optim.py:75-91``): the trainer
sets the groups' lr *after* ``optimizer.step()``, so step 0 runs at
``config.lr`` (times the group's multiplier) and step i at
``schedule(i - 1)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn

from cavp_tpu_torch.engine.schedules import warmup_poly_schedule

SGD_GROUPS = ("seg_decay", "seg_nodecay", "bkb_decay", "bkb_nodecay", "fusion")
GROUPS = SGD_GROUPS + ("audio",)


def param_label(name: str, is_kernel: bool) -> str:
    """The optimizer group of the parameter called ``name``;
    ``is_kernel``: it is the weight of a conv or a linear layer."""
    if name.startswith("audio_backbone"):
        return "audio"
    if name.startswith("segment"):
        return "seg_decay" if is_kernel else "seg_nodecay"
    if name.startswith("backbone"):
        return "bkb_decay" if is_kernel else "bkb_nodecay"
    return "fusion"  # cross_att + visual_projector: one plain group


def label_params(model: nn.Module) -> Dict[str, str]:
    """{parameter name: group label} for every parameter of ``model``."""
    kernels = {f"{prefix}.weight" if prefix else "weight"
               for prefix, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))}
    return {name: param_label(name, name in kernels)
            for name, _ in model.named_parameters()}


class Optimizers:
    """The SGD over the five scheduled groups and the Adam over the audio
    tower, stepped together."""

    def __init__(self, sgd: torch.optim.SGD, adam: torch.optim.Adam,
                 schedule: Callable[[int], float], base_lr: float):
        self.sgd, self.adam = sgd, adam
        self.schedule, self.base_lr = schedule, base_lr

    def lr_at(self, count: int) -> float:
        """The SGD base lr that step ``count`` runs at (before the
        group's multiplier)."""
        return self.base_lr if count == 0 else self.schedule(count - 1)

    def step(self, count: int) -> None:
        lr = self.lr_at(count)
        for group in self.sgd.param_groups:
            group["lr"] = group["lr_multiplier"] * lr
        self.sgd.step()
        self.adam.step()

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"sgd": self.sgd.state_dict(), "adam": self.adam.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.adam.load_state_dict(state["adam"])


def make_optimizer(model: nn.Module, config, steps_per_epoch: int = None
                   ) -> Tuple[Optimizers, Callable[[int], float]]:
    """The full two-optimizer structure over ``model``'s parameters.
    Returns (optimizers, schedule)."""
    if steps_per_epoch is None:
        steps_per_epoch = config.steps_per_epoch
    schedule = warmup_poly_schedule(config.lr, config.lr_power,
                                    steps_per_epoch * config.epochs,
                                    steps_per_epoch * config.warm_up_epoch)
    labels = label_params(model)
    by_group = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        by_group[labels[name]].append(p)
    sgd = torch.optim.SGD(
        [{"params": by_group[g], "name": g,
          "lr_multiplier": 10.0 if g.startswith("seg") else 1.0,
          "lr": config.lr * (10.0 if g.startswith("seg") else 1.0),
          "weight_decay": 0.0 if g.endswith("nodecay") else config.weight_decay}
         for g in SGD_GROUPS],
        lr=config.lr, momentum=config.momentum, dampening=0.0, nesterov=False)
    adam = torch.optim.Adam([{"params": by_group["audio"], "name": "audio"}],
                            lr=config.lr, betas=(0.9, 0.999), eps=1e-8)
    return Optimizers(sgd, adam, schedule, config.lr), schedule


def current_lrs(schedule: Callable[[int], float], config, count: int
                ) -> Dict[str, float]:
    """The lr display values of the reference's ``lr_step``."""
    lr = schedule(count)
    return {"lr/lr_seg": lr * 10.0, "lr/lr_bkb": lr, "lr/lr_attn": lr,
            "lr/lr_audio": config.lr}
