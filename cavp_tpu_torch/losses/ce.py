"""Cross-entropy with ``ignore_index`` (``cavp_tpu/losses/ce.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = 255) -> torch.Tensor:
    """logits [..., C] (classes last, any strides), labels [...] int.
    Mean of the float32 negative log-likelihood over the pixels whose
    label is not ``ignore_index``; 0 when every pixel is ignored (torch's
    own mean reduction gives NaN there)."""
    x = logits.float().movedim(-1, 1)
    labels = labels.long()
    total = F.cross_entropy(x, labels, ignore_index=ignore_index, reduction="sum")
    count = (labels != ignore_index).sum().clamp_min(1)
    return total / count
