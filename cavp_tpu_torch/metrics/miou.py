"""Streaming mean-IoU / pixel accuracy (``cavp_tpu/metrics/miou.py``).

The reference's +1 class shift, ignore -> -1 handling and
histogram-based intersection/union, as a functional accumulator carried
on the device. Per-frame histograms come from one scatter-add of ones
over frame-offset values into a histogram of fixed size (the TPU's
compare+reduce form avoided scatters; the GPU has fast atomics).
Accumulators are float64, so counts stay exact integers far beyond
float32's 2**24.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cavp_tpu_torch.device import resolve_device


class MIoUState(NamedTuple):
    inter: torch.Tensor    # [num_classes]
    union: torch.Tensor    # [num_classes]
    correct: torch.Tensor  # scalar
    labeled: torch.Tensor  # scalar


def miou_init(num_classes: int, device=None) -> MIoUState:
    """Zeroed accumulators on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    z = torch.zeros((num_classes,), dtype=torch.float64, device=device)
    s = torch.zeros((), dtype=torch.float64, device=device)
    return MIoUState(z, z.clone(), s, s.clone())


def counts(idx: torch.Tensor, size: int, weight: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """int64 [size]: how often each value of ``idx`` (int64, all in
    [0, size)) occurs, each occurrence counted ``weight`` times (default 1):
    ``torch.bincount(idx, weight, minlength=size)``. ``torch.bincount``
    sizes its output from the data's largest value, which on the card
    makes the host wait for the device; this fixed-size scatter does not."""
    src = torch.ones_like(idx) if weight is None else weight
    return torch.zeros(size, dtype=torch.int64, device=idx.device).scatter_add_(0, idx, src)


def frame_hist(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-frame counts of the values 1..num_classes: x [B, P] int ->
    [B, num_classes] float64. Other values are not counted."""
    B = x.shape[0]
    v = torch.where((x >= 1) & (x <= num_classes), x, torch.zeros_like(x))
    idx = v + (num_classes + 1) * torch.arange(B, device=x.device).unsqueeze(1)
    h = counts(idx.reshape(-1), B * (num_classes + 1))
    return h.reshape(B, num_classes + 1)[:, 1:].double()


def miou_update_weighted(states: Tuple[MIoUState, ...], pred: torch.Tensor,
                         target: torch.Tensor,
                         weights: Tuple[Optional[torch.Tensor], ...],
                         ignore_index: int = 255) -> Tuple[MIoUState, ...]:
    """Update several accumulators that differ only by a per-frame weight
    (ALL vs the multi-source subset) from one set of per-frame
    histograms. pred: [..., H, W] 0-based argmax; target: [..., H, W]
    (``ignore_index`` = unlabeled); ``None`` weight = all ones."""
    num_classes = states[0].inter.shape[0]
    npix = target.shape[-2] * target.shape[-1]
    t = torch.where(target == ignore_index, -1, target.long()) + 1
    tf = t.reshape(-1, npix)
    pf = (pred.long() + 1).reshape(-1, npix)
    batch = tf.shape[0]

    labeled = tf > 0
    correct_f = ((pf == tf) & labeled).sum(1).double()
    labeled_f = labeled.sum(1).double()
    pm = pf * labeled
    h_inter = frame_hist(pm * (pm == tf), num_classes)
    h_pred = frame_hist(pm, num_classes)
    h_lab = frame_hist(tf, num_classes)

    out = []
    for st, w in zip(states, weights):
        wv = (torch.ones(batch, dtype=torch.float64, device=tf.device) if w is None
              else w.reshape(batch).double())
        area_inter = wv @ h_inter
        out.append(MIoUState(
            inter=st.inter + area_inter,
            union=st.union + (wv @ h_pred + wv @ h_lab - area_inter),
            correct=st.correct + wv @ correct_f,
            labeled=st.labeled + wv @ labeled_f))
    return tuple(out)


def miou_result(state: MIoUState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mIoU, acc): mean over all classes including absent ones, with
    numpy.spacing(1) in the denominators (``eval_utils.py:43-61``)."""
    eps = 2.220446049250313e-16
    iou = state.inter / (eps + state.union)
    return iou.mean(), state.correct / (eps + state.labeled)
