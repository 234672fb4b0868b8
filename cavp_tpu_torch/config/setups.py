"""Per-setup configuration: the fields the ported avss slices read.

Mirrors ``cavp_tpu/config/setups.py``: the same field names, defaults
and ``get_config`` dispatch, cut to what the eval, serving and train
steps use. The data roots, the logging fields and the TPU-only knobs
come with the PRs that port their code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List


@dataclass
class Config:
    """One setup. Defaults follow ``config/config_avss.py``."""

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

    # --- optimisation ---
    lr: float = 1e-3
    lr_power: float = 0.9
    batch_size: int = 16
    epochs: int = 60
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warm_up_epoch: int = 0
    steps_per_epoch: int = 1000
    corocl_w: float = 1.0  # the reference adds l_ctr_av unweighted
    cl_temp: float = 0.1
    max_view: int = 512
    ow_rate: float = 0.5
    class_slots: int = 16  # static per-batch class budget of the CoroCL sampler

    # --- runtime ---
    gpus: int = 1   # data-parallel workers; scales the sound bank's depth
    nodes: int = 1
    avsbench_split: str = "all"
    # exact audio-tower dedup on the train path (VGG tower, no BatchNorm):
    # the tower runs on B + floor(B*ow_rate) clips and the shuffled half
    # is a feature gather
    audio_dedup: bool = True

    # --- precision / kernels ---
    compute_dtype: str = "bfloat16"  # dtype of conv/matmul activations
    # the fusion stage (projector + patch embeds + sigmoid-CA block +
    # final norm) through the hand-written CUDA kernel on the eval path
    use_pallas_fusion: bool = False
    # the train step's dup=2 fusion stage through the hand-written CUDA
    # forward and backward kernels (``ops/kernels/fusion_train.py``)
    use_pallas_fusion_train: bool = False

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
