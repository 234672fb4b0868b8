"""Train CAVP on AVSBench-Semantics on the CUDA card (the resize path).

    python -m cavp_tpu_torch.main_avss_resize --setup avss --resize_flag \\
        --root_dataset_dir <dir holding avsbench_semantic/> [--epochs 60] \\
        [--batch_size 16] [--ckpt_path checkpoints/preempt.pth] \\
        [--use_pallas_fusion_train --use_pallas_mel --use_pallas_fusion \\
         --use_pallas_argmax --use_pallas_layer1]

The port of the root ``main_avss_resize.py`` (the reference's working
AVSS train entry): the same command line, one engine
(:func:`cavp_tpu_torch.engine.runner.run_training`). ``--batch_size`` is
per worker and ``--gpus`` scales the global batch and the lr; one card
trains the global batch. Checkpoints land in ``./checkpoints``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from cavp_tpu_torch.config import load_args_and_config
from cavp_tpu_torch.data.avss import AVSSDataset
from cavp_tpu_torch.data.pipeline import collate_train_videos
from cavp_tpu_torch.engine.runner import run_training
from cavp_tpu_torch.utils import log_to_console, logger


def make_datasets(config):
    return AVSSDataset(config, "train"), AVSSDataset(config, "test"), collate_train_videos


def main(argv: Optional[Sequence[str]] = None, device=None, stats: Optional[dict] = None):
    """Train for the command line ``argv`` (default: ``sys.argv[1:]``) on
    ``device`` (default: the CUDA card; raises when there is none).
    Returns (state, best_miou); ``stats`` is passed on to ``run_training``."""
    log_to_console()
    config = load_args_and_config(argv)
    logger.warning("RUNNING AVSS (resize)")
    logger.warning(f"SETUP: {config.setup} | EPOCH: {config.epochs} | "
                   f"BACKBONE: {config.visual_backbone} | "
                   f"BATCH SIZE: {config.batch_size} | LR: {config.lr}")
    return run_training(config, variant="avss", make_datasets=make_datasets, device=device,
                        stats=stats)


if __name__ == "__main__":
    main()
