"""CLI flag surface (``cavp_tpu/config/flags.py``).

The reference's flags, with the same names and defaults, dispatched onto
the setup registry: flags passed on the command line win over the setup's
values, and flags left at their argparse default do not overwrite the
fields a setup owns (lr, epochs, batch_size, ...). The JAX package's
TPU-only knobs (tf.data input, the fused optimizer, the conv
decompositions, XLA options, the wandb eval list) have no counterpart
here and are not accepted. Flags of features the port does not have yet
raise ``NotImplementedError`` naming their ``ROADMAP.md`` item when they
are set.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

from cavp_tpu_torch.config.setups import Config, get_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Audio-Visual Recognition (PyTorch/CUDA)")
    # hardware / launch
    parser.add_argument("--pvc", action="store_true", help="pvc or not")
    parser.add_argument("--dgx", action="store_true", help="dgx or not")
    parser.add_argument("--gpus", default=1, type=int, help="# data-parallel workers")
    parser.add_argument("--nodes", default=1, type=int)
    parser.add_argument("--local_rank", default=0, type=int)
    parser.add_argument("--num_workers", default=8, type=int)
    # wandb / run metadata
    parser.add_argument("--wandb_mode", default="disabled", type=str)
    parser.add_argument("--wandb_dir", default="./", type=str)
    parser.add_argument("--tags", nargs="+", default="")
    parser.add_argument("--run_note", default="", type=str)
    parser.add_argument("--experiment_name", default="ca+dp_ctr", type=str)
    # model
    parser.add_argument("--num_queries", default=100, type=int)
    parser.add_argument("--visual_backbone", type=int, default=50)
    parser.add_argument("--seg_model", type=str, default="DeepLabV3Plus")
    parser.add_argument("--use_baseline", default=False, action="store_true")
    # data
    parser.add_argument("--semi_ratio", default="1/1", type=str)
    parser.add_argument("--setup", default="coco", type=str)
    parser.add_argument("--use_synthetic", default=False, action="store_true")
    # flags
    parser.add_argument("--cavp_flag", default=False, action="store_true")
    parser.add_argument("--cutmix_flag", default=False, action="store_true")
    parser.add_argument("--resize_flag", default=False, action="store_true")
    # optimisation
    parser.add_argument("--batch_size", default=16, type=int)
    parser.add_argument("--lr_power", default=0.9, type=float)
    parser.add_argument("--lr", default=0.02, type=float)
    parser.add_argument("--lr_aud", default=1e-4, type=float)
    parser.add_argument("--lrs_seg", default=10, type=float)
    parser.add_argument("--lrs_bkb", default=0.5, type=float)
    parser.add_argument("--weight_decay", default=1e-4, type=float)
    parser.add_argument("--epochs", default=60, type=int)
    parser.add_argument("--loss_w", default=0.1, type=float)
    # mode
    parser.add_argument("--ignore_ckpt", default=False, action="store_true")
    parser.add_argument("--local", default=False, action="store_true")
    parser.add_argument("--use_multi_source", default=False, action="store_true")
    parser.add_argument("--debug", default=False, action="store_true")
    parser.add_argument("--ow_rate", default=0.5, type=float)
    # model hyper
    parser.add_argument("--cl_temp", default=0.1, type=float)
    parser.add_argument("--corocl_w", default=1.0, type=float,
                        help="CoroCL weight (reference: unweighted, =1); "
                             "0 disables the contrastive objective")
    parser.add_argument("--max_view", default=512, type=int)
    # avsbench
    parser.add_argument("--avsbench_split", default="all", type=str)
    parser.add_argument("--data_root", default="", type=str)
    parser.add_argument("--root_dataset_dir", default=None, type=str,
                        help="override the dataset root (avsbench_semantic parent dir)")
    # extras of the JAX package that the port has
    parser.add_argument("--compute_dtype", default="bfloat16", type=str,
                        choices=["bfloat16", "float32"])
    parser.add_argument("--class_slots", default=16, type=int,
                        help="static class budget per batch for CoroCL sampling")
    parser.add_argument("--use_pallas_mel", default=False, action="store_true",
                        help="the log-mel frontend through its CUDA kernel")
    parser.add_argument("--use_pallas_fusion", default=False, action="store_true",
                        help="the eval fusion stage through its CUDA kernel")
    parser.add_argument("--use_pallas_fusion_train", default=False, action="store_true",
                        help="the train fusion stage through its CUDA kernels")
    parser.add_argument("--use_pallas_layer1", default=False, action="store_true",
                        help="eval: ResNet layer1 through its CUDA kernel")
    parser.add_argument("--use_pallas_argmax", default=False, action="store_true",
                        help="eval, with --use_pallas_fusion: the logit upsample "
                             "and the argmax as one CUDA kernel")
    parser.add_argument("--no_audio_dedup", dest="audio_dedup", default=True,
                        action="store_false",
                        help="disable the exact train-path audio-tower dedup")
    parser.add_argument("--ckpt_path", default="", type=str,
                        help="the .pth checkpoint to load")
    return parser


# Config fields that the setup modules own; only explicitly-passed CLI
# values may override them.
_SETUP_OWNED = {
    "lr", "epochs", "batch_size", "weight_decay", "num_workers",
    "visual_backbone", "lr_power",
}

# flags of features not ported yet, and the ROADMAP.md item that ports each
_NOT_PORTED_FLAGS = {"wandb_mode": "Queue 1 item 3"}


def _explicit_flags(argv: Sequence[str]) -> set:
    out = set()
    for tok in argv:
        if tok.startswith("--"):
            out.add(tok[2:].split("=")[0])
    return out


def load_args_and_config(argv: Optional[Sequence[str]] = None) -> Config:
    """Parse the CLI and merge it onto the setup config."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    for key, item in _NOT_PORTED_FLAGS.items():
        if getattr(args, key) != parser.get_default(key):
            raise NotImplementedError(
                f"--{key} {getattr(args, key)} is not ported yet (ROADMAP.md {item})")
    cfg = get_config(args.setup)
    explicit = _explicit_flags(argv)

    field_names = {f.name for f in dataclasses.fields(Config)}
    updates = {}
    for key, value in vars(args).items():
        if key not in field_names:
            continue
        if key in _SETUP_OWNED and key not in explicit:
            continue  # setup config owns this value
        if value is None and key not in explicit:
            continue  # None-default flags only apply when passed
        updates[key] = value
    cfg = cfg.replace(**updates)

    # derived, as in the reference entry points: lr *= gpus, the 71
    # classes of the full avss split and the VPO setups' class count
    cfg = cfg.replace(lr=cfg.lr * cfg.gpus)
    if cfg.setup == "avss" and cfg.avsbench_split == "all":
        cfg = cfg.replace(num_classes=71)
    if cfg.use_vpo:
        cfg = cfg.replace(num_classes=cfg.vpo_num_classes)
    return cfg
