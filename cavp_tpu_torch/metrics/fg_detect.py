"""Foreground detection metrics (FDR / F1 / F0.3) from a confusion matrix
(``cavp_tpu/metrics/fg_detect.py``, reference ``eval_utils.py:100-156``).

Per-frame confusions come from one ``torch.bincount`` (the reference's
numpy.bincount form) instead of the TPU's one-hot matmul; float64
accumulators keep the counts exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cavp_tpu_torch.device import resolve_device


def fg_init(num_classes: int, device=None) -> torch.Tensor:
    """A zeroed confusion matrix on ``device`` (default: the CUDA card)."""
    return torch.zeros((num_classes, num_classes), dtype=torch.float64,
                       device=resolve_device(device))


def fg_update_weighted(confusions: Tuple[torch.Tensor, ...], pred: torch.Tensor,
                       target: torch.Tensor,
                       weights: Tuple[Optional[torch.Tensor], ...],
                       ignore_index: int = 255) -> Tuple[torch.Tensor, ...]:
    """Update several confusion matrices [true, pred] that differ only by
    a per-frame 0/1 weight, from one set of per-frame confusions.
    Pixels whose target is out of range or ``ignore_index``, or whose
    prediction is out of range, are not counted."""
    n = confusions[0].shape[0]
    npix = target.shape[-2] * target.shape[-1]
    tf = target.long().reshape(-1, npix)
    pf = pred.long().reshape(-1, npix)
    batch = tf.shape[0]
    keep = (tf >= 0) & (tf < n) & (tf != ignore_index) & (pf >= 0) & (pf < n)
    frame = torch.arange(batch, device=tf.device).unsqueeze(1).expand_as(tf)
    idx = (frame * n + tf) * n + pf
    conf_f = torch.bincount(idx[keep], minlength=batch * n * n)
    conf_f = conf_f.reshape(batch, n, n).double()

    out = []
    for conf, w in zip(confusions, weights):
        wv = (torch.ones(batch, dtype=torch.float64, device=tf.device) if w is None
              else w.reshape(batch).double())
        out.append(conf + torch.einsum("b,bij->ij", wv, conf_f))
    return tuple(out)


def _masked_mean(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over ``valid`` entries; NaN when none is valid (the
    reference's nanmean over present classes)."""
    cnt = valid.sum()
    s = torch.where(valid, vals, torch.zeros_like(vals)).sum()
    return torch.where(cnt > 0, s / cnt.clamp(min=1), torch.full_like(s, float("nan")))


def fg_result(confusion: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fdr, f1, f0.3) — ``eval_utils.py:124-149``; each NaN when no
    class is valid."""
    tp = torch.diagonal(confusion)
    fp = confusion.sum(0) - tp
    fn = confusion.sum(1) - tp
    pos = fp + tp
    fdr = _masked_mean(fp / pos.clamp(min=1), pos > 0)

    def f_beta(beta2):
        denom = (1 + beta2) * tp + beta2 * fn + fp
        return _masked_mean((1 + beta2) * tp / denom.clamp(min=1), denom > 0)

    return fdr, f_beta(1.0), f_beta(0.3)
