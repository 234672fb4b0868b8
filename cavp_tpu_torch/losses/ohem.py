"""OHEM cross-entropy (``cavp_tpu/losses/ohem.py``; the reference's
``ProbOhemCrossEntropy2d``, unused by its trainers).

The pixels whose probability of their label is above a threshold are
ignored, the threshold raised to the ``min_kept``-th smallest such
probability where that is higher; with static shapes, by a sort.
"""

from __future__ import annotations

import torch

from cavp_tpu_torch.losses.ce import cross_entropy
from cavp_tpu_torch.models.layers import acc_dtype


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                       thresh: float = 0.6, min_kept: int = 256) -> torch.Tensor:
    """logits [B, H, W, classes], labels [B, H, W]."""
    c = logits.shape[-1]
    flat_logits = logits.reshape(-1, c)
    flat_labels = labels.reshape(-1).long()
    # the reference gates all filtering on min_kept > 0 and skips it when
    # fewer pixels than min_kept are valid
    if min_kept <= 0:
        return cross_entropy(flat_logits, flat_labels, ignore_index)
    valid = flat_labels != ignore_index
    safe = torch.where(valid, flat_labels, 0)
    prob = torch.softmax(flat_logits.to(acc_dtype(logits.dtype)), dim=-1)
    gt_prob = torch.where(valid, prob.gather(1, safe[:, None])[:, 0], 1.0)
    k = min(min_kept, gt_prob.shape[0]) - 1
    kth = torch.sort(gt_prob).values[max(k, 0)]
    threshold = torch.where(kth > thresh, kth, thresh)
    apply = (valid.sum() > 0) & (valid.sum() >= min_kept)
    drop = apply & valid & (gt_prob > threshold)
    return cross_entropy(flat_logits, torch.where(drop, ignore_index, flat_labels), ignore_index)
