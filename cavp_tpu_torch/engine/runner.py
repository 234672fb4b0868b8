"""Model construction (``cavp_tpu/engine/runner.py`` ``build_model``)."""

from __future__ import annotations

from typing import Optional

import torch

from cavp_tpu_torch.config.setups import Config
from cavp_tpu_torch.models.cavp import CAVP
from cavp_tpu_torch.models.layers import init_parameters


def build_model(config: Config, device="cpu",
                generator: Optional[torch.Generator] = None) -> CAVP:
    """The eval-mode ``CAVP`` for ``config`` on ``device``, in
    ``channels_last`` memory format, with float32 parameters drawn from
    ``generator`` (default: seeded with ``config.seed``)."""
    model = CAVP(num_classes=config.num_classes, seg_model=config.seg_model,
                 visual_backbone=config.visual_backbone,
                 last_three_dilation_stride=tuple(config.last_three_dilation_stride),
                 audio_backbone=config.audio_backbone, in_plane=config.in_plane,
                 dtype=torch.bfloat16 if config.compute_dtype == "bfloat16"
                 else torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    init_parameters(model, generator)
    return model.to(device=device, memory_format=torch.channels_last).eval()
