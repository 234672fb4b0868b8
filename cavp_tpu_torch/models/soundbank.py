"""SoundBank: per-class FIFO queues of waveforms, carried in the train state
(``cavp_tpu/models/soundbank.py``).

Pure functions over a fixed-shape ``[num_classes, bank_size, dim]``
tensor:

- :func:`update_bank`: zero the background label; a sample with exactly
  one remaining source class is enqueued FIFO into that class's row, in
  batch order (the avss rule), or, with ``per_label``, into the row of
  each of its source classes (the VPO rule);
- :func:`overwrite_miss_match`: of the mismatched pairs a random
  ``ow_rate`` fraction becomes *matched* pairs: marked matched with the
  original labels, their shuffled waveform replaced by the oldest banked
  waveform of the sample's single source class
  (:func:`overwrite_from_bank`).

The JAX package writes these scatter-free for the TPU; here plain
indexing does the same, with no host synchronisation. The random scores
of the overwrite are an argument, so that a test can hand both packages
the same draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.models.layers import acc_dtype


def init_bank(num_classes: int, bank_size: int, dim: int, device=None) -> torch.Tensor:
    return torch.zeros((num_classes, bank_size, dim), dtype=torch.float32,
                       device=resolve_device(device))


def single_source_class(img_label: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(class_idx [B], is_single [B]): the one foreground class of the
    single-source samples (column 0, the background, does not count)."""
    fg = img_label.clone()
    fg[:, 0] = 0
    count = (fg > 0).sum(1)
    return fg.argmax(1), count == 1


def update_bank(bank: torch.Tensor, items: torch.Tensor, img_label: torch.Tensor,
                per_label: bool = False) -> torch.Tensor:
    """FIFO-enqueue ``items`` [B, dim] by class, in batch order; returns
    the new bank. ``per_label=False`` (the avss rule): a sample with one
    source class enqueues into that class's row; ``per_label=True`` (the
    VPO rule, ``trainer_cavp_vpo_stereo.py:38-54``): every sample enqueues
    into the row of each of its source classes.

    Rows are independent, so with m_c items entering row c the result is
    ``concat(row, items_of_c)[m_c : m_c + N]``: the old entries move up by
    m_c and the item of rank r lands at ``N + r - m_c`` (dropped when
    that is negative: more than N entered and it is not among the newest
    N)."""
    C, N, _ = bank.shape
    dev = bank.device
    if per_label:
        enq = img_label > 0
        enq[:, 0] = False                                                  # [B, C]
    else:
        cls, single = single_source_class(img_label)
        enq = torch.nn.functional.one_hot(cls, C).bool() & single[:, None]
    onehot = enq.long()
    m = onehot.sum(0)                                                      # [C]
    rank = onehot.cumsum(0) - onehot                                       # [B, C]
    src = (torch.arange(N, device=dev)[None, :] + m[:, None]).clamp_max(N - 1)
    moved = torch.gather(bank, 1, src[:, :, None].expand(-1, -1, bank.shape[2]))
    # one spare row takes the items that do not enter
    out = torch.cat([moved, bank.new_zeros((1,) + tuple(bank.shape[1:]))])
    pos = N + rank - m[None, :]
    enters = enq & (pos >= 0)
    rows = torch.where(enters, torch.arange(C, device=dev)[None, :], C)
    out.index_put_((rows, torch.where(enters, pos, 0)),
                   items.to(bank.dtype)[:, None, :].expand(-1, C, -1))
    return out[:C]


def overwrite_from_bank(bank: torch.Tensor, shuffled: torch.Tensor,
                        change_mask: torch.Tensor, target_class: torch.Tensor
                        ) -> torch.Tensor:
    """shuffled[i] <- bank[target_class[i], 0] where ``change_mask``."""
    return torch.where(change_mask[:, None], bank[target_class, 0], shuffled)


class OverwriteResult(NamedTuple):
    if_match: torch.Tensor           # [B] bool, updated
    shuffle_img_label: torch.Tensor  # [B, C], updated
    change_mask: torch.Tensor        # [B] bool: pairs made matched
    target_class: torch.Tensor       # [B] int: class to pull from the bank


def overwrite_miss_match(if_match: torch.Tensor, shuffle_img_label: torch.Tensor,
                         img_label: torch.Tensor, ow_rate: float,
                         scores: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         filter_bg_only: bool = False, enabled=True) -> OverwriteResult:
    """Select floor(n_false * ow_rate) random mismatched pairs (the k
    largest of the uniform ``scores`` [B]; drawn from ``generator`` when
    not given), drop the multi-source ones (and the background-only ones
    with ``filter_bg_only``), and mark the rest matched with their true
    labels. ``enabled`` (bool or 0-dim tensor) gates the whole step."""
    B = if_match.shape[0]
    dev = if_match.device
    cls, single = single_source_class(img_label)
    mismatched = ~if_match
    n_false = mismatched.sum()
    k = torch.floor(n_false.to(torch.float32) * ow_rate).long()
    if scores is None:
        scores = torch.rand(B, generator=generator, device=dev)
    scores = scores.to(acc_dtype(scores.dtype))
    scores = torch.where(mismatched, scores, torch.full_like(scores, float("-inf")))
    # a gather, not an index by a 0-dim tensor: that reads the index on the host
    kth = torch.sort(scores, descending=True).values.gather(0, (k - 1).clamp(0, B - 1)[None])
    selected = mismatched & (scores >= kth) & (k > 0) & single
    if filter_bg_only:
        selected = selected & ~(img_label.sum(1) == 1)
    selected = selected & enabled
    return OverwriteResult(if_match | selected,
                           torch.where(selected[:, None], img_label, shuffle_img_label),
                           selected, cls)
