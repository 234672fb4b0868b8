"""The secondary contrastive objectives, with static budgets
(``cavp_tpu/losses/contrast_extra.py``).

The reference's ``Losser`` holds them without using them in the active
objective; the train step adds the last two under ``config.extra_losses``
(``"av_contrast"``, ``"pixel_contrast"``), weighted by ``config.loss_w``.

- :func:`supcon_loss`: supervised contrastive loss (Khosla et al.);
- :func:`av_contrast_loss`: the audio embedding against the masked mean of
  the visual tokens, a 2-view SupCon with one foreground class an image;
- :func:`pixel_contrast_loss`: ContrastiveSeg's hard-anchor pixel InfoNCE
  over fixed (image, class) slots.

The pixel sampler's uniform draws are the argument ``scores`` [B, slots, 2,
h*w] (hard, then easy); when it is None they come from ``generator``. The
math runs in the features' dtype, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from cavp_tpu_torch.ops.interp import interpolate_bilinear_separable, interpolate_nearest

_NEG_INF = -1e9


def _info_nce_core(features, mask, logits_mask, temperature, base_temperature, eps=0.0):
    """SupCon's log-probabilities: the denominator sums exp over every
    non-self pair, the positives included."""
    dots = (features @ features.t()) / temperature
    logits = dots - dots.max(dim=1, keepdim=True).values.detach()
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True) + 1e-30)
    pos = mask * logits_mask
    mean_log_prob_pos = (pos * log_prob).sum(dim=1) / (pos.sum(dim=1) + (eps or 1e-12))
    return (-(temperature / base_temperature) * mean_log_prob_pos).mean()


def _pixelcontrast_core(features, mask, logits_mask, temperature, valid_rows, eps):
    """PixelContrastLoss._contrastive: per pair ``exp(logit) + the sum over
    the negatives`` in the denominator (other positives left out)."""
    pair_valid = valid_rows[:, None] * valid_rows[None, :]
    on = pair_valid > 0
    dots = torch.where(on, (features @ features.t()) / temperature, _NEG_INF)
    logits_max = dots.max(dim=1, keepdim=True).values.clamp_min(_NEG_INF / 2).detach()
    logits = dots - logits_max
    exp_logits = torch.exp(torch.where(on, logits, _NEG_INF))
    neg_sum = (exp_logits * ((1.0 - mask) * pair_valid)).sum(dim=1, keepdim=True)
    log_prob = logits - torch.log(exp_logits + neg_sum + 1e-30)
    pos = mask * logits_mask
    mean_log_prob_pos = (pos * log_prob).sum(dim=1) / (pos.sum(dim=1) + eps)
    loss_vec = torch.where(valid_rows > 0, -mean_log_prob_pos, 0.0)
    return loss_vec.sum() / valid_rows.sum().clamp_min(1.0)


def _view_major(x: torch.Tensor) -> torch.Tensor:
    """[N, views, D] -> [views * N, D], view 0 of every row first (torch's
    ``cat(unbind(dim=1))``)."""
    return x.transpose(0, 1).reshape(-1, x.shape[-1])


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                temperature: float = 0.07, base_temperature: float = 0.07) -> torch.Tensor:
    """features [B, n_views, D]; labels [B] (None: SimCLR's identity mask)."""
    b, n_views = features.shape[:2]
    dev = features.device
    if labels is None:
        mask = torch.eye(b, device=dev)
    else:
        mask = (labels[:, None] == labels[None, :]).float()
    mask = mask.repeat(n_views, n_views)
    logits_mask = 1.0 - torch.eye(b * n_views, device=dev)
    return _info_nce_core(_view_major(features), mask, logits_mask, temperature,
                          base_temperature)


def av_contrast_loss(f_v: torch.Tensor, f_a: torch.Tensor, labels: torch.Tensor,
                     temperature: float = 0.1, ignore_index: int = 255,
                     feat_hw=(128, 128)) -> torch.Tensor:
    """f_v [B, h*w, C] visual tokens, f_a [B, C] audio embeddings, labels
    [B, H, W]. The visual tokens are L2-normalized over the pixels (axis 1)
    and the audio over the channels; each image's foreground mean of the
    tokens meets the audio in a 2-view SupCon whose target is the image's
    smallest foreground class (images without one only count as
    negatives)."""
    b = f_v.shape[0]
    eps = 1e-12
    f_v = f_v / torch.linalg.vector_norm(f_v, dim=1, keepdim=True).clamp_min(eps)
    f_a = f_a / torch.linalg.vector_norm(f_a, dim=1, keepdim=True).clamp_min(eps)

    lab = interpolate_nearest(labels, tuple(feat_hw)).reshape(b, -1)
    is_fg = (lab != 0) & (lab != ignore_index)
    fg = is_fg.float()
    masked_v = (fg[..., None] * f_v).sum(dim=1) / (fg.sum(dim=1, keepdim=True) + eps)

    big = ignore_index + 1
    target = torch.where(is_fg, lab, big).min(dim=1).values
    has_fg = target < big
    target = torch.where(has_fg, target, ignore_index)

    features = torch.cat([f_a, masked_v], dim=0)  # [2B, C], view-major
    mask = (target[:, None] == target[None, :]).float()
    mask = torch.where(has_fg[:, None], mask, 0.0).repeat(2, 2)
    logits_mask = 1.0 - torch.eye(2 * b, device=f_v.device)
    return _info_nce_core(features, mask, logits_mask, temperature, temperature, eps=eps)


def pixel_contrast_loss(feats: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor,
                        temperature: float = 0.1, max_views: int = 100,
                        slots_per_image: int = 4, ignore_index: int = 255,
                        scores: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """feats [B, h, w, C] (the fused feature), logits [B, H, W, classes],
    labels [B, H, W]. ContrastiveSeg's sampling with static budgets: the
    classes of an image's label map (at the feature's size) with more than
    ``max_views`` pixels, background included and the ignore label out,
    fill ``slots_per_image`` slots in ascending class id; a slot takes
    ``max_views`` anchors, half of them hard (labelled as the class but
    predicted otherwise, by the argmax of the logits resized to the
    feature's size) and the rest easy where both sides have enough, else
    what the short side leaves; each side's anchors are its pixels with the
    largest ``scores``."""
    b, h, w, c_dim = feats.shape
    hw = h * w
    n_view = max_views
    n2 = n_view // 2
    eps = 1e-12
    dev = feats.device
    S = slots_per_image
    if scores is None:
        scores = torch.rand(b, S, 2, hw, generator=generator, device=dev)
    if tuple(scores.shape) != (b, S, 2, hw):
        raise ValueError(f"scores must be [{b}, {S}, 2, {hw}], got {tuple(scores.shape)}")

    feats = feats.reshape(b, hw, c_dim)
    feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True).clamp_min(eps)
    predict = interpolate_bilinear_separable(logits, (h, w)).argmax(-1).reshape(b, hw)
    lab = interpolate_nearest(labels, (h, w)).reshape(b, hw).long()

    num_classes = logits.shape[-1]
    ids = torch.arange(num_classes, device=dev)
    counts = (lab[:, :, None] == ids).sum(dim=1)               # [B, classes]
    big = num_classes + 1
    slot_cls = torch.sort(torch.where(counts > max_views, ids, big), dim=1).values[:, :S]
    slot_valid = slot_cls < big                                  # [B, S]

    cls = slot_cls[:, :, None]                                   # [B, S, 1]
    is_cls = lab[:, None, :] == cls                              # [B, S, hw]
    hit = predict[:, None, :] == cls
    hard, easy = is_cls & ~hit, is_cls & hit
    nh, ne = hard.sum(-1), easy.sum(-1)                          # [B, S]
    nhk = torch.where((nh >= n2) & (ne >= n2), n2, torch.where(nh >= n2, n_view - ne, nh))
    nhk = nhk.clamp(0, n_view)

    def draw(s, m):
        return torch.topk(torch.where(m, s, _NEG_INF), n_view, dim=-1).indices

    hard_idx = draw(scores[:, :, 0], hard)                       # [B, S, V]
    easy_idx = draw(scores[:, :, 1], easy)
    j = torch.arange(n_view, device=dev)
    easy_at = torch.gather(easy_idx, 2, (j - nhk[..., None]).clamp_min(0))
    idx = torch.where(j < nhk[..., None], hard_idx, easy_at)
    sampled = torch.gather(feats[:, None].expand(b, S, hw, c_dim), 2,
                           idx[..., None].expand(b, S, n_view, c_dim))  # [B, S, V, C]

    total = b * S
    y = slot_cls.reshape(total)
    valid = slot_valid.reshape(total).float()
    flat = _view_major(sampled.reshape(total, n_view, c_dim))
    vmask = valid.repeat(n_view)
    same = (y[:, None] == y[None, :]).float() * valid[:, None] * valid[None, :]
    mask = same.repeat(n_view, n_view)
    logits_mask = (1.0 - torch.eye(total * n_view, device=dev)) * vmask[None, :] * vmask[:, None]
    return _pixelcontrast_core(flat, mask, logits_mask, temperature, vmask, eps)
