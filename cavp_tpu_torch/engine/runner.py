"""Model and train-state construction (``cavp_tpu/engine/runner.py``
``build_model`` and ``init_state``)."""

from __future__ import annotations

from typing import Optional

import torch

from cavp_tpu_torch.config.setups import Config
from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.optim import make_optimizer
from cavp_tpu_torch.engine.state import TrainState, create_train_state
from cavp_tpu_torch.models.cavp import CAVP
from cavp_tpu_torch.models.layers import init_parameters


def build_model(config: Config, device=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> CAVP:
    """The ``CAVP`` for ``config`` on ``device`` (default: the CUDA card;
    raises when there is none), in eval mode unless ``train``, in
    ``channels_last`` memory format, with float32 parameters drawn from
    ``generator`` (default: seeded with ``config.seed``)."""
    device = resolve_device(device)
    model = CAVP(num_classes=config.num_classes, seg_model=config.seg_model,
                 visual_backbone=config.visual_backbone,
                 last_three_dilation_stride=tuple(config.last_three_dilation_stride),
                 audio_backbone=config.audio_backbone, in_plane=config.in_plane,
                 dtype=torch.bfloat16 if config.compute_dtype == "bfloat16"
                 else torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    init_parameters(model, generator)
    return model.to(device=device, memory_format=torch.channels_last).train(train)


def init_state(config: Config, device=None,
               steps_per_epoch: Optional[int] = None) -> TrainState:
    """A train-mode model from ``config.seed``, its optimizers and the
    state at step 0, on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    model = build_model(config, device, train=True)
    optimizers, _ = make_optimizer(model, config, steps_per_epoch)
    return create_train_state(model, optimizers, config, device)
