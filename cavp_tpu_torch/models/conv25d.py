"""Depth-aware 2.5-D convolutions (``cavp_tpu/models/conv25d.py``; the
reference's ``utils/conv_2_5d.py``, where they are only ``group_weight``
targets).

A 3x3 convolution with three kernels, one a depth plane: each tap of a
pixel's neighbourhood goes to the plane whose band it falls in, the bands
one grid cell apart around the centre pixel's depth (|d - (c + g)| <= g/2,
|d - c| <= g/2, |d - (c - g)| <= g/2, with g = pixel_size * c / fx), and a
tap in no band adds nothing. ``Conv2_5D_disp`` reads disparity instead:
depth = baseline * fx / clamp(disparity, 0.01, 256), and a tap of zero
disparity (or a centre of zero disparity) goes to the centre plane. Plain
PyTorch (``F.unfold``), NCHW; the sums run in float32 (at least). The
parameters keep the reference's names, ``weight_0`` / ``weight_1`` /
``weight_2`` [out, in, 3, 3] (the planes c + g, c, c - g) and ``bias``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.layers import acc_dtype


def _camera(params, group: str, key: str, default: float):
    try:
        return params[group][key]
    except (KeyError, TypeError, IndexError):
        return default


class Conv2_5D(nn.Module):
    mode = "depth"
    default_pixel_size = 1.0

    def __init__(self, in_channels: int, out_channels: int,
                 pixel_size: Optional[float] = None, camera_params: Any = None):
        super().__init__()
        self.pixel_size = self.default_pixel_size if pixel_size is None else pixel_size
        self.camera_params = camera_params
        bound = 1.0 / math.sqrt(in_channels * 9)  # torch's conv default
        for p in range(3):
            w = torch.empty(out_channels, in_channels, 3, 3).uniform_(-bound, bound)
            setattr(self, f"weight_{p}", nn.Parameter(w))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, depth: torch.Tensor, camera_params=None):
        """x [B, C, H, W], depth (or disparity) [B, H, W] -> [B, out, H, W];
        ``camera_params`` {"intrinsic": {"fx": ...}, "extrinsic":
        {"baseline": ...}}, scalars or per-sample [B]."""
        B, C, H, W = x.shape
        adt = acc_dtype(x.dtype)
        patches = F.unfold(x.to(adt), 3, padding=1).reshape(B, C, 9, H, W)
        d = F.unfold(depth[:, None].to(adt), 3, padding=1).reshape(B, 9, H, W)
        cp = camera_params or self.camera_params or {}
        as4 = lambda v: torch.as_tensor(v, dtype=adt, device=x.device).reshape(-1, 1, 1, 1)
        fx = as4(_camera(cp, "intrinsic", "fx", 1.0))
        valid = None
        if self.mode == "disp":
            baseline = as4(_camera(cp, "extrinsic", "baseline", 1.0))
            valid = (d != 0).to(adt)
            valid = valid * valid[:, 4:5]
            d = (baseline * fx) / (d * valid).clamp(0.01, 256.0)
        center = d[:, 4:5]
        grid = self.pixel_size * center / fx
        masks = [((d - (center + grid)).abs() <= grid / 2).to(adt),
                 ((d - center).abs() <= grid / 2).to(adt),
                 ((d - (center - grid)).abs() <= grid / 2).to(adt)]
        if valid is not None:  # invalid taps go to the centre plane
            masks[1] = (masks[1] + 1.0 - valid).clamp(0.0, 1.0)
        out = sum(torch.einsum("bnhw,bcnhw,fcn->bfhw", m, patches,
                               getattr(self, f"weight_{p}").to(adt).reshape(-1, C, 9))
                  for p, m in enumerate(masks))
        return (out + self.bias.to(adt)[:, None, None]).to(x.dtype)


class Conv2_5D_depth(Conv2_5D):
    mode = "depth"
    default_pixel_size = 1.0


class Conv2_5D_disp(Conv2_5D):
    mode = "disp"
    default_pixel_size = 16.0
