"""Label resizing (``cavp_tpu/ops/interp.py``).

Only the nearest rule is needed here: the bilinear resizes of the model
go to ``F.interpolate``, which follows the same torch conventions that
the JAX package rebuilds.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _nearest_coords(in_size: int, out_size: int) -> np.ndarray:
    # torch's "nearest": src = floor(dst * in/out), not half-pixel rounding
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def interpolate_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[..., H, W] -> resized on the last two axes by torch's asymmetric
    nearest rule. Works on integer labels, which ``F.interpolate`` does
    not take on every device."""
    rows = torch.from_numpy(_nearest_coords(x.shape[-2], size[0])).to(x.device)
    cols = torch.from_numpy(_nearest_coords(x.shape[-1], size[1])).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)
