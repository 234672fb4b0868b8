"""Resizing on the JAX package's conventions (``cavp_tpu/ops/interp.py``).

The bilinear resizes of the model go to ``F.interpolate``, which follows
the same torch conventions that the JAX package rebuilds. Two things are
kept here: the nearest rule for labels, and the separable bilinear resize
with the JAX package's rounding points (H pass, round to the IO dtype, W
pass, round; the interpolation weights themselves rounded to the IO
dtype), which is the unfused arm the upsample + argmax kernel
(:mod:`cavp_tpu_torch.ops.kernels.upsample_argmax`) is bitwise equal to.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _nearest_coords(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The source row of every output row on ``device``, uploaded once (a
    copy to the card on every call makes the host wait), outside inference
    mode so that any caller may use it."""
    # torch's "nearest": src = floor(dst * in/out), not half-pixel rounding
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    with torch.inference_mode(False):
        return torch.from_numpy(np.minimum(idx, in_size - 1)).to(device)


def interpolate_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[..., H, W] -> resized on the last two axes by torch's asymmetric
    nearest rule. Works on integer labels, which ``F.interpolate`` does
    not take on every device."""
    rows = _nearest_coords(x.shape[-2], size[0], x.device)
    cols = _nearest_coords(x.shape[-1], size[1], x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


@functools.lru_cache(maxsize=None)
def _linear_coords(in_size: int, out_size: int, align_corners: bool):
    if align_corners:
        if out_size == 1:
            src = np.zeros(1)
        else:
            src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


@functools.lru_cache(maxsize=None)
def interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense [out, in] float32 interpolation matrix, at most two nonzeros
    per row (``cavp_tpu.ops.interp._interp_matrix``)."""
    lo, hi, w = _linear_coords(in_size, out_size, align_corners)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    return m


@functools.lru_cache(maxsize=None)
def axis_taps(in_size: int, out_size: int, align_corners: bool, dtype: torch.dtype):
    """The two taps of every output position of one axis, read off
    :func:`interp_matrix` after it is rounded to ``dtype``: (lo, hi) int64
    [out] and their weights (w_lo, w_hi) float32 [out]. Where both taps
    fall on one source position, ``w_hi`` is 0 and ``w_lo`` the entry."""
    lo, hi, _ = _linear_coords(in_size, out_size, align_corners)
    m = torch.from_numpy(interp_matrix(in_size, out_size, align_corners)).to(dtype).float()
    rows = torch.arange(out_size)
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    w_hi = torch.where(hi != lo, m[rows, hi], torch.zeros(out_size))
    return lo, hi, m[rows, lo], w_hi


@functools.lru_cache(maxsize=None)
def _interp_matrix_on(in_size: int, out_size: int, align_corners: bool,
                      device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`interp_matrix` rounded to ``dtype`` on ``device``, uploaded
    once (a copy to the card on every call makes the host wait), outside
    inference mode so that any caller may use it."""
    with torch.inference_mode(False):
        m = torch.from_numpy(interp_matrix(in_size, out_size, align_corners))
        return m.to(device, dtype)


def _interp_axis(x: torch.Tensor, axis: int, out_size: int, align_corners: bool
                 ) -> torch.Tensor:
    """One axis as a matrix product against :func:`interp_matrix` rounded
    to x's dtype, as the JAX package does it; the product rounds once."""
    m = _interp_matrix_on(x.shape[axis], out_size, align_corners, x.device, x.dtype)
    shape = x.shape
    flat = x.reshape(math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:]))
    out = torch.matmul(m, flat)
    return out.reshape(*shape[:axis], out_size, *shape[axis + 1:])


def interpolate_bilinear_separable(x: torch.Tensor, size: Tuple[int, int],
                                   align_corners: bool = False) -> torch.Tensor:
    """[..., H, W, C] -> [..., size[0], size[1], C]: the H pass, rounded to
    x's dtype, then the W pass, rounded. For bf16 each pass equals the
    two-tap sum of :func:`axis_taps` bit for bit: a row of the matrix has
    at most two nonzeros, their products are exact in the float32 the
    product sums in, and the other terms are zeros. For float32 the
    product may fuse a multiply-add, so the two agree to an ulp."""
    x = _interp_axis(x, x.dim() - 3, size[0], align_corners)
    return _interp_axis(x, x.dim() - 2, size[1], align_corners)
