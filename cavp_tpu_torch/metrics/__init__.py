from cavp_tpu_torch.metrics.fg_detect import fg_init, fg_result, fg_update_weighted
from cavp_tpu_torch.metrics.jf import color_miou_fscore, eval_fmeasure, mask_iou
from cavp_tpu_torch.metrics.localization import Evaluator, EvaluatorFull
from cavp_tpu_torch.metrics.miou import (
    MIoUState,
    counts,
    miou_init,
    miou_result,
    miou_update_weighted,
)

__all__ = [
    "MIoUState", "counts", "miou_init", "miou_update_weighted", "miou_result",
    "fg_init", "fg_update_weighted", "fg_result",
    "mask_iou", "eval_fmeasure", "color_miou_fscore", "Evaluator", "EvaluatorFull",
]
