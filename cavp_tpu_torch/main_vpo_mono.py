"""Train CAVP on VPO with mono audio on the CUDA card.

    python -m cavp_tpu_torch.main_vpo_mono --setup vpo_ss|vpo_ms|vpo_msmi \\
        --root_dataset_dir <dir holding VPO/ and vggsound_bench/> [--epochs 80] \\
        [--batch_size 16] [--ckpt_path checkpoints/preempt.pth] \\
        [--use_pallas_fusion_train --use_pallas_mel --use_pallas_fusion \\
         --use_pallas_argmax --use_pallas_layer1]

The port of the root ``main_vpo_mono.py``: the setup's CSV
(``vpo_{ss,ms,msmi}_data_mono.csv``, multi-source for VPO-MS and
VPO-MSMI), the ResNet-18 audio tower on 3 s of mono audio, the
``vpo_mono`` train step (the wave bank and the overwrite, the tower on the
2B matched and shuffled clips) and a validation of single frames,
``--batch_size`` of them a step, as the JAX package takes them (frames at
their size on disk). Checkpoints land in ``./checkpoints``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from cavp_tpu_torch.config import load_args_and_config
from cavp_tpu_torch.data.pipeline import collate_eval_frames
from cavp_tpu_torch.data.vpo import make_datasets
from cavp_tpu_torch.engine.runner import run_training
from cavp_tpu_torch.utils import log_to_console, logger


def main(argv: Optional[Sequence[str]] = None, device=None, stats: Optional[dict] = None,
         stereo: bool = False):
    """Train for the command line ``argv`` (default: ``sys.argv[1:]``) on
    ``device`` (default: the CUDA card; raises when there is none).
    Returns (state, best_miou); ``stats`` is passed on to ``run_training``.
    ``stereo``: ``main_vpo_stereo``'s run (2 audio channels)."""
    log_to_console()
    config = load_args_and_config(argv)
    if stereo:
        config = config.replace(in_plane=2)
    logger.warning(f"RUNNING VPO {'STEREO' if stereo else 'MONO'}")
    logger.warning(f"SETUP: {config.setup} | EPOCH: {config.epochs} | "
                   f"BACKBONE: {config.visual_backbone} | "
                   f"BATCH SIZE: {config.batch_size} | LR: {config.lr}")
    return run_training(config, variant="vpo_stereo" if stereo else "vpo_mono",
                        make_datasets=lambda c: make_datasets(c, stereo=stereo), device=device,
                        eval_collate=collate_eval_frames, eval_batch_size=config.batch_size,
                        stats=stats)


if __name__ == "__main__":
    main()
