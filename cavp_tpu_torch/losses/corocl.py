"""CoroCL: the cross-modal region contrastive loss, with static budgets
(``cavp_tpu/losses/corocl.py``).

The JAX package reformulates the reference's dynamically shaped sampling
with fixed budgets and validity masks; the port keeps that form, so both
packages can be driven by the same draws:

- the label maps are nearest-downsampled to the feature resolution;
- **foreground anchors**: every foreground class with at least
  ``max_views`` pixels is eligible; eligible classes fill ``class_slots``
  slots in ascending class id, and each slot draws ``max_views`` pixels
  uniformly without replacement (the top-k of uniform scores);
- **background and shuffle anchors**: ``sample_num = min(max_views,
  n_fg, n_bg)`` pixels of the matched background, and of the shuffled
  embeddings at the matched-foreground positions;
- only the gathered rows are L2-normalized (normalization is row-wise,
  so it commutes with the gather);
- **InfoNCE** over the anchors against themselves: positives share a
  label, the diagonal is out, invalid slots are masked with ``-1e9`` and
  contribute exactly zero.

The uniform scores are an argument ``scores`` [class_slots + 2, P], one
row per group (class slots, then background, then shuffle); when it is
None they come from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cavp_tpu_torch.ops.interp import interpolate_nearest

_NEG_INF = -1e9


def _sample_group(scores: torch.Tensor, mask: torch.Tensor, num_samples: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``num_samples`` True positions of ``mask`` [P] with the largest
    ``scores`` [P]: (idx, valid), where valid is False for the tail when
    fewer positions are True."""
    top, idx = torch.topk(torch.where(mask, scores, _NEG_INF), num_samples)
    return idx, top > _NEG_INF / 2


def _norm(e: torch.Tensor) -> torch.Tensor:
    e = e.float()
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp_min(1e-12)


def corocl_loss(embeds_match: torch.Tensor, gt_match: torch.Tensor,
                embeds_shuffle: torch.Tensor, gt_shuffle: torch.Tensor, *,
                num_classes: int, temperature: float = 0.1, max_views: int = 512,
                class_slots: int = 8, ignore_index: int = 255,
                scores: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """embeds_* [B, h, w, C]; gt_* [B, H, W] int labels (255 = ignore).
    Returns (loss, aux counters)."""
    B, h, w, C = embeds_match.shape
    P = B * h * w
    dev = embeds_match.device
    class_slots = min(class_slots, num_classes)
    if scores is None:
        scores = torch.rand(class_slots + 2, P, generator=generator, device=dev)
    if scores.shape != (class_slots + 2, P):
        raise ValueError(f"scores must be [{class_slots + 2}, {P}], "
                         f"got {tuple(scores.shape)}")
    scores = scores.float()

    gt_m = interpolate_nearest(gt_match, (h, w)).reshape(P).long()
    gt_s = interpolate_nearest(gt_shuffle, (h, w)).reshape(P).long()
    em = embeds_match.reshape(P, C)
    es = embeds_shuffle.reshape(P, C)

    fg_mask = (gt_m > 0) & (gt_m != ignore_index)
    bg_mask = gt_m == 0

    # eligible classes -> static slots, ascending class id
    counts = torch.bincount(torch.where(fg_mask, gt_m, num_classes),
                            minlength=num_classes + 1)[:num_classes]
    eligible = counts >= max_views
    eligible[0] = False
    big = num_classes + 1
    ids = torch.arange(num_classes, device=dev)
    slot_class = torch.sort(torch.where(eligible, ids, big)).values[:class_slots]
    slot_valid = slot_class < big
    n_eligible = eligible.sum()

    cls_mask = fg_mask[None, :] & (gt_m[None, :] == slot_class[:, None])  # [S, P]
    cls_idx = torch.topk(torch.where(cls_mask, scores[:class_slots], _NEG_INF),
                         max_views, dim=1).indices                        # [S, V]
    cls_anchor = _norm(em[cls_idx.reshape(-1)])
    cls_labels = slot_class.repeat_interleave(max_views)
    cls_valid = slot_valid.repeat_interleave(max_views)

    # background + shuffle groups
    n_bg = bg_mask.sum()
    n_shuf = fg_mask.sum()  # shuffle pixels sit at the matched-fg positions
    sample_num = torch.minimum(torch.clamp_max(n_shuf, max_views), n_bg)
    within = torch.arange(max_views, device=dev) < sample_num

    bg_idx, bg_hit = _sample_group(scores[-2], bg_mask, max_views)
    bg_anchor = _norm(em[bg_idx])
    sh_idx, sh_hit = _sample_group(scores[-1], fg_mask, max_views)
    sh_anchor = _norm(es[sh_idx])

    anchors = torch.cat([cls_anchor, bg_anchor, sh_anchor], dim=0)
    labels = torch.cat([cls_labels, gt_m[bg_idx], gt_s[sh_idx]], dim=0)
    valid = torch.cat([cls_valid, bg_hit & within, sh_hit & within], dim=0)
    # the reference returns 0 when no foreground class is eligible
    valid = valid & (n_eligible > 0)

    loss = _masked_info_nce(anchors, labels, valid, temperature)
    aux = {
        "corocl/eligible_classes": n_eligible,
        "corocl/dropped_classes": (n_eligible - class_slots).clamp_min(0),
        "corocl/anchor_count": valid.sum(),
    }
    return loss, aux


def _masked_info_nce(anchors: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, temperature: float) -> torch.Tensor:
    """InfoNCE of the anchors against themselves with validity masking."""
    n = anchors.shape[0]
    vf = valid.float()
    pair_valid = vf[:, None] * vf[None, :]
    pair_on = pair_valid > 0

    same = (labels[:, None] == labels[None, :]).float() * pair_valid
    dots = (anchors @ anchors.t()) / temperature
    dots = torch.where(pair_on, dots, _NEG_INF)

    logits_max = dots.max(dim=1, keepdim=True).values.clamp_min(_NEG_INF / 2)
    logits = dots - logits_max.detach()

    pos_mask = same * (1.0 - torch.eye(n, device=anchors.device))
    neg_mask = (1.0 - same) * pair_valid

    exp_logits = torch.exp(torch.where(pair_on, logits, _NEG_INF))
    neg_logits = (exp_logits * neg_mask).sum(dim=1, keepdim=True)

    log_prob = logits - torch.log(exp_logits + neg_logits + 1e-30)
    mean_log_prob_pos = (pos_mask * log_prob).sum(dim=1) / (pos_mask.sum(dim=1) + 1e-12)
    mean_log_prob_pos = torch.where(valid, mean_log_prob_pos, 0.0)
    return -mean_log_prob_pos.sum() / vf.sum().clamp_min(1.0)
