"""Per-setup configuration: the fields the ported slices read.

Mirrors ``cavp_tpu/config/setups.py``: the same field names, defaults
and ``get_config`` dispatch, cut to what the eval, serving and train
steps, the training entry points (``cavp_tpu_torch.main_avss[_resize]``,
``cavp_tpu_torch.main_vpo_{mono,stereo}``) and the evaluation entry
points (``cavp_tpu_torch.test_avs_semantic``,
``cavp_tpu_torch.test_avss_resize``) use: the ``avss``, ``avss_binary``
and ``vpo_{ss,ms,msmi}`` setups. The TPU-only knobs have no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional

from cavp_tpu_torch.config.class_list import (
    COCO_CLASS_DICT,
    INDEX_TABLE_AVS,
    INDEX_TABLE_COCO,
)


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

    # --- data roots ---
    root_dataset_dir: str = "../audio_visual"  # holds avsbench_semantic/
    dataset_name: str = "avsbench_data_single_yh/"
    data_root: str = ""  # holds avsbench_data/ (the S4 and MS3 trees)
    use_vpo: bool = False
    vgg_root: str = "vggsound_bench/VGGSound"  # holds audios/<vgg_file>.wav
    vpo_root: str = ""  # holds the VPO CSVs and the COCO data/ and mask/ trees
    vpo_num_classes: int = 22
    index_table: List[str] = field(default_factory=lambda: list(INDEX_TABLE_AVS))
    class_dict: Optional[dict] = None  # COCO id -> class name of the VPO masks
    replace_name: bool = False

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
    num_workers: int = 16  # loader threads
    use_baseline: bool = False  # the visual-only VisualModel, CE only
    avsbench_split: str = "all"
    # stored only, as in the JAX package: the VPO entry points take the
    # multi-source mode from the setup's name
    use_multi_source: bool = False
    resize_flag: bool = False  # resize frames and masks to image_height x width
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
    # the trainer log-mel frontend through its CUDA kernel
    # (``ops/kernels/mel.py``), in the eval and the train step
    use_pallas_mel: bool = False
    # eval: ResNet layer1 through the fused bottleneck kernels
    # (``ops/kernels/layer1.py``)
    use_pallas_layer1: bool = False
    # eval, with ``use_pallas_fusion``: the logit upsample and the argmax
    # as one kernel (``ops/kernels/upsample_argmax.py``)
    use_pallas_argmax: bool = False
    # drop the padding frames (v1 videos fill 5 of 10 slots) from the eval
    # batches and repack them densely: the same metric sums, fewer steps
    eval_dense_pack: bool = True
    ckpt_path: str = ""  # the checkpoint to evaluate, or to resume training from

    # --- the training loop ---
    ignore_ckpt: bool = False  # write no best_model checkpoint
    # raise at the first non-finite loss, read where the loop reads the
    # metrics anyway (the JAX package's jax_debug_nans)
    debug: bool = False
    display_iter: int = 1  # steps between two metric reads

    @property
    def data_path(self) -> str:
        return os.path.join(self.root_dataset_dir, self.dataset_name)

    @property
    def vgg_data_path(self) -> str:
        return os.path.join(self.root_dataset_dir, self.vgg_root)

    @property
    def vpo_data_path(self) -> str:
        return os.path.join(self.root_dataset_dir, self.vpo_root)

    @property
    def coco_img_root(self) -> str:
        return os.path.join(self.vpo_data_path, "data")

    @property
    def coco_mask_root(self) -> str:
        return os.path.join(self.vpo_data_path, "mask")

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


def _avss_binary() -> Config:
    return Config(setup="avss_binary", image_width=224, image_height=224,
                  dataset_name="avsbench_data_single_plus/", num_classes=2)


def _vpo(variant: str) -> Config:
    """VPO-SS, VPO-MS or VPO-MSMI (``config_vpo_{ss,ms,msmi}.py``): COCO
    images with VGGSound clips of 3 s, a ResNet-101 at output stride 8 and
    the ResNet-18 audio tower. ``num_classes`` is 24 here; the command
    line pins it to ``vpo_num_classes`` (``config/flags.py``)."""
    return Config(
        setup=f"vpo_{variant}", audio_len=3.0, dataset_name="avsbench_data_single_plus/",
        use_vpo=True, index_table=list(INDEX_TABLE_COCO), class_dict=dict(COCO_CLASS_DICT),
        vpo_root=f"VPO/VPO-{variant.upper()}/", vpo_num_classes=22, visual_backbone=101,
        last_three_dilation_stride=[False, True, True],
        audio_backbone="18",  # 3 s of audio: the ResNet-18 tower
        epochs=80, weight_decay=5e-4, num_classes=24, num_workers=8)


SETUPS = {"avss": _avss, "avss_binary": _avss_binary, "vpo_ss": lambda: _vpo("ss"),
          "vpo_ms": lambda: _vpo("ms"), "vpo_msmi": lambda: _vpo("msmi")}


def get_config(setup: str) -> Config:
    """Return the base config for a ``--setup`` name."""
    try:
        return SETUPS[setup]()
    except KeyError:
        raise ValueError(f"Unknown setup {setup!r}; choose from {sorted(SETUPS)}")
