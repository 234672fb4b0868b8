"""Evaluate a CAVP checkpoint on AVSBench-Semantics on the CUDA card.

    python -m cavp_tpu_torch.test_avs_semantic --setup avss \\
        --root_dataset_dir <dir holding avsbench_semantic/> --ckpt_path avss_224.pth \\
        [--resize_flag] [--use_pallas_fusion --use_pallas_argmax \\
         --use_pallas_mel --use_pallas_layer1]

The port of the root ``test_avs_semantic.py``: load a reference ``.pth``
by its state-dict names, run the batched validation once over the test
split (8 videos a batch under ``--resize_flag``, else 1), and log the
``|ALL|`` and ``|MS|`` metric lines. ``main`` returns the ten metrics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from cavp_tpu_torch.config import load_args_and_config
from cavp_tpu_torch.data.avss import AVSSDataset
from cavp_tpu_torch.data.pipeline import DataLoader, collate_eval_videos
from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.checkpoint import load_model_variables
from cavp_tpu_torch.engine.runner import build_model, run_validation
from cavp_tpu_torch.utils import log_to_console, logger


def main(argv: Optional[Sequence[str]] = None, device=None,
         stats: Optional[dict] = None) -> Dict[str, float]:
    """Run the evaluation for the command line ``argv`` (default:
    ``sys.argv[1:]``) on ``device`` (default: the CUDA card; raises when
    there is none). ``stats`` is passed on to ``run_validation``."""
    log_to_console()
    config = load_args_and_config(argv)
    device = resolve_device(device)
    model = build_model(config, device)

    ckpt = config.ckpt_path or "./avss_224.pth"
    report = load_model_variables(ckpt, model)
    if report["unexpected"]:
        logger.warning(f"checkpoint tensors with no place in the model: {report['unexpected'][:10]}")
    if report["missing"]:
        logger.warning(f"model tensors the checkpoint did not fill: {report['missing'][:10]}")

    test_ds = AVSSDataset(config, "test")
    videos_per_batch = 8 if config.resize_flag else 1
    loader = DataLoader(test_ds, videos_per_batch, collate_eval_videos,
                        num_workers=config.num_workers)
    results = run_validation(config, model, loader, device, stats=stats)
    logger.info(
        "|ALL| mIoU: %.4f | acc: %.4f | fdr: %.4f | f_1: %.4f | f_0.3: %.4f"
        % (results["miou"], results["acc"], results["fdr"], results["f_1"],
           results["f_0.3"]))
    logger.info(
        "|MS| mIoU: %.4f | acc: %.4f | fdr: %.4f | f_1: %.4f | f_0.3: %.4f"
        % (results["miou_ms"], results["acc_ms"], results["fdr_ms"],
           results["f_1_ms"], results["f_0.3_ms"]))
    return results


if __name__ == "__main__":
    main()
