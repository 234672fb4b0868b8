"""Per-setup configuration: the fields the avss eval slice reads.

Mirrors ``cavp_tpu/config/setups.py``: the same field names, defaults
and ``get_config`` dispatch, cut to what the ported slice uses. Fields
of the train path, the data roots and the TPU-only knobs come with the
PRs that port their code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List


@dataclass
class Config:
    """One eval setup. Defaults follow ``config/config_avss.py``."""

    setup: str = "avss"
    seed: int = 666

    # --- image ---
    image_width: int = 512
    image_height: int = 512
    image_mean: List[float] = field(default_factory=lambda: [0.485, 0.456, 0.406])
    image_std: List[float] = field(default_factory=lambda: [0.229, 0.224, 0.225])

    # --- audio ---
    audio_len: float = 1.0
    spec_min: float = -100.0
    spec_max: float = 100.0

    # --- model ---
    num_classes: int = 71
    visual_backbone: int = 50
    seg_model: str = "DeepLabV3Plus"
    last_three_dilation_stride: List[bool] = field(
        default_factory=lambda: [False, False, False]
    )
    audio_backbone: str = "vgg"
    in_plane: int = 1  # audio input channels

    # --- precision / kernels ---
    compute_dtype: str = "bfloat16"  # dtype of conv/matmul activations
    # the fusion stage (projector + patch embeds + sigmoid-CA block +
    # final norm) through the hand-written CUDA kernel on the eval path
    use_pallas_fusion: bool = False

    @property
    def mel_frames(self) -> int:
        """Trainer-mel time frames kept: 96 for 1 s audio, 300 for 3 s."""
        return 96 if self.audio_len == 1.0 else 300

    @property
    def audio_samples(self) -> int:
        return int(16000 * self.audio_len)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _avss() -> Config:
    return Config(setup="avss")


SETUPS = {"avss": _avss}


def get_config(setup: str) -> Config:
    """Return the base config for a ``--setup`` name."""
    try:
        return SETUPS[setup]()
    except KeyError:
        raise ValueError(f"Unknown setup {setup!r}; choose from {sorted(SETUPS)}")
