"""AVSBench J&F metrics on the device (``cavp_tpu/metrics/jf.py``).

The reference's ``utils/avsbench_utils.py:229-304`` (``mask_iou``, the J
measure, and ``Eval_Fmeasure``, the F measure with its 255-threshold
sweep) and ``utils/avsbench_metrics.py:23-77`` (``calc_color_miou_fscore``,
the per-frame multi-class iou and F accumulators).

The threshold sweep is a histogram and a reversed cumulative sum: for the
thresholds t_i of ``linspace(0, 1 - 1e-10, 255)``, ``#{p : pred_p >= t_i}``
is the number of pixels whose ``searchsorted(..., right=True)`` bucket
exceeds i. The histograms are one fixed-size scatter over frame-offset
buckets (``metrics.miou.counts``), so nothing waits for the device, and
their counts are exact integers before they become float32.

Every function takes any number of leading dimensions before the frame
axis: ``[..., N, H, W]`` gives ``[...]`` (one value per video of a
``[V, T, H, W]`` batch, the JAX package's ``vmap``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from cavp_tpu_torch.metrics.miou import counts, frame_hist

_EPS_SPACING = 2.220446049250313e-16


def thresholds(pr_num: int = 255, device=None) -> torch.Tensor:
    """float32 [pr_num]: ``jnp.linspace(0.0, 1.0 - 1e-10, pr_num)`` bit for
    bit: ``i * ((stop - 0) / (pr_num - 1))`` for i < pr_num - 1, then
    ``stop``, all in float32, where ``stop`` = float32(1 - 1e-10) = 1.0."""
    stop = torch.tensor(1.0 - 1e-10, dtype=torch.float32, device=device)
    delta = stop / torch.tensor(float(pr_num - 1), dtype=torch.float32, device=device)
    steps = torch.arange(pr_num - 1, dtype=torch.float32, device=device) * delta
    return torch.cat([steps, stop[None]])


def _weighted_mean(values: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the last axis, of the entries with weight (0/1) only."""
    if weight is None:
        return values.mean(-1)
    w = weight.float()
    return (values * w).sum(-1) / w.sum(-1).clamp_min(1.0)


def mask_iou(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-7,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The J measure (avsbench_utils.py:229-254): pred, target [..., N, H, W]
    in {0, 1}; the mean IoU over the N frames. A frame whose target is
    empty scores the IoU of the background (the pixels both leave empty,
    over all pixels). ``weight`` [..., N] (0/1) leaves out padded frames,
    the mean dividing by their number."""
    pred = pred.float()
    target = target.float()
    num_pixels = pred.shape[-1] * pred.shape[-2]
    no_obj = target.sum((-2, -1)) == 0
    inter = (pred * target).sum((-2, -1))
    union = torch.maximum(pred, target).sum((-2, -1))
    inter_no_obj = ((1 - target) * (1 - pred)).sum((-2, -1))
    inter = torch.where(no_obj, inter_no_obj, inter)
    union = torch.where(no_obj, torch.full_like(union, float(num_pixels)), union)
    return _weighted_mean(inter / (union + eps), weight)


def _pr_curves(pred: torch.Tensor, gt: torch.Tensor, pr_num: int = 255
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame precision and recall over the ``pr_num`` thresholds
    (``_eval_pr``, avsbench_utils.py:257-270): pred [..., H, W] probabilities
    in [0, 1], gt [..., H, W] in {0, 1} -> ([..., pr_num], [..., pr_num])."""
    lead = pred.shape[:-2]
    n = math.prod(lead)
    flat = pred.reshape(n, -1).float()
    gt_flat = gt.reshape(n, -1).long()
    th = thresholds(pr_num, pred.device)
    bucket = torch.searchsorted(th, flat.contiguous(), right=True)  # in 0..pr_num
    bins = pr_num + 1
    idx = (bucket + bins * torch.arange(n, device=pred.device).unsqueeze(1)).reshape(-1)
    hist_all = counts(idx, n * bins).reshape(n, bins)
    hist_tp = counts(idx, n * bins, gt_flat.reshape(-1)).reshape(n, bins)
    # count_i = #{p : bucket_p > i} = the sum of hist[b] over b > i
    rev = lambda h: h.flip(-1).cumsum(-1).flip(-1)[:, 1:].float()
    y_temp_sum, tp = rev(hist_all), rev(hist_tp)
    prec = tp / (y_temp_sum + 1e-20)
    recall = tp / (gt_flat.sum(-1, keepdim=True).float() + 1e-20)
    return prec.reshape(lead + (pr_num,)), recall.reshape(lead + (pr_num,))


def eval_fmeasure(pred: torch.Tensor, gt: torch.Tensor, pr_num: int = 255,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The F measure (avsbench_utils.py:273-304): pred [..., N, H, W] class-1
    probabilities, gt [..., N, H, W] in {0, 1}; the largest over the
    thresholds of the mean F0.3 curve of the frames. Frames with an empty
    gt, and frames of weight 0, are left out."""
    beta2 = 0.3
    prec, recall = _pr_curves(pred, gt, pr_num)
    f = (1 + beta2) * prec * recall / (beta2 * prec + recall)
    f = torch.nan_to_num(f, nan=0.0)
    keep = gt.float().mean((-2, -1)) > 0
    if weight is not None:
        keep = keep & (weight > 0)
    kf = keep.float()
    img_num = kf.sum(-1).clamp_min(1.0)
    score = (f * kf.unsqueeze(-1)).sum(-2) / img_num.unsqueeze(-1)
    return score.amax(-1)


def color_miou_fscore(logits: torch.Tensor, target: torch.Tensor,
                      weight: Optional[torch.Tensor] = None, beta2: float = 0.3
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The multi-class per-frame iou and F accumulators
    (``_batch_miou_fscore``, avsbench_metrics.py:23-64): logits [BF, H, W,
    C], target [BF, H, W], weight [BF]. Returns (ious [C], fscores [C],
    cls_count [C]) summed over the frames; a caller sums them over batches
    and finishes with sum(iou) / sum(count) per class."""
    nclass = logits.shape[-1]
    bf = logits.shape[0]
    predict = logits.argmax(-1).long() + 1
    tgt = target.long() + 1
    predict = predict * (tgt > 0)
    intersection = predict * (predict == tgt)

    def hist(x):  # [BF, C]: per-frame counts of the values 1..C
        return frame_hist(x.reshape(bf, -1), nclass).float()

    area_inter, area_pred, area_lab = hist(intersection), hist(predict), hist(tgt)
    area_union = area_pred + area_lab - area_inter
    iou = area_inter / (_EPS_SPACING + area_union)
    count = (area_union > 0).float()
    precision = area_inter / area_pred
    recall = area_inter / area_lab
    fscore = torch.nan_to_num((1 + beta2) * precision * recall / (beta2 * precision + recall),
                              nan=0.0)
    if weight is not None:
        w = weight.float()[:, None]
        iou, fscore, count = iou * w, fscore * w, count * w
    return iou.sum(0), fscore.sum(0), count.sum(0)
