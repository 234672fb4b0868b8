"""Evaluate a checkpoint on AVSBench-Object (the S4 / MS3 J&F test) on the CUDA card.

    python -m cavp_tpu_torch.test_avss_resize --setup avss_binary \\
        --data_root <dir holding avsbench_data/> --avsbench_split v1s|v1m \\
        --ckpt_path cavp_avsobj_ss.pth [--resize_flag] [--use_baseline]

The port of the root ``test_avss_resize.py``: a 2-class model (``CAVP``, or
``VisualModel`` under ``--use_baseline``), a reference ``.pth`` loaded by
its state-dict names with a report of what did not match, the S4 test split
for ``v1s`` and the MS3 one for ``v1m``, 4 videos a batch under
``--resize_flag`` (else 1), and the ``mIoU | F | J&F`` line. ``main``
returns the three numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from cavp_tpu_torch.config import load_args_and_config
from cavp_tpu_torch.data.avsbench import MS3Dataset, S4Dataset
from cavp_tpu_torch.data.pipeline import DataLoader, collate_eval_videos
from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.checkpoint import load_model_variables
from cavp_tpu_torch.engine.runner import build_model, run_jf_test
from cavp_tpu_torch.utils import log_to_console, logger


def main(argv: Optional[Sequence[str]] = None, device=None,
         stats: Optional[dict] = None, report: Optional[dict] = None) -> Dict[str, float]:
    """Run the J&F test for the command line ``argv`` (default:
    ``sys.argv[1:]``) on ``device`` (default: the CUDA card; raises when
    there is none). ``stats`` is passed on to ``run_jf_test``; ``report``,
    when given, receives the checkpoint load's report."""
    log_to_console()
    # the binary test: 2 classes (test_avss_resize.py:254-255)
    config = load_args_and_config(argv).replace(num_classes=2)
    if config.avsbench_split == "v1s":
        test_ds = S4Dataset(config, "test")
    elif config.avsbench_split == "v1m":
        test_ds = MS3Dataset(config, "test")
    else:
        raise ValueError("use --avsbench_split v1s|v1m for the J&F test")
    device = resolve_device(device)
    model = build_model(config, device)

    loaded = load_model_variables(config.ckpt_path or "./cavp_avsobj_ss.pth", model)
    if report is not None:
        report.update(loaded)
    if loaded["unexpected"]:
        logger.warning(f"checkpoint tensors with no place in the model: {loaded['unexpected'][:10]}")
    if loaded["missing"]:
        logger.warning(f"model tensors the checkpoint did not fill: {loaded['missing'][:10]}")

    videos_per_batch = 4 if config.resize_flag else 1
    loader = DataLoader(test_ds, videos_per_batch, collate_eval_videos,
                        num_workers=config.num_workers)
    results = run_jf_test(config, model, loader, device, stats=stats)
    logger.info("mIoU: {miou:.4f} | F: {F_score:.4f} | J&F: {jf:.4f}".format(
        jf=results["J&F"], **results))
    return results


if __name__ == "__main__":
    main()
