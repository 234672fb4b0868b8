"""LR schedules as plain functions of the step count
(``cavp_tpu/engine/schedules.py``)."""

from __future__ import annotations

from typing import Callable

import numpy as np


def warmup_poly_schedule(start_lr: float, lr_power: float, total_iters: int,
                         warmup_steps: int, end_lr: float = 1e-8
                         ) -> Callable[[int], float]:
    """``lr_policy.WarmUpPolyLR``: linear warmup, then poly decay clipped
    to [end_lr, start_lr]. Computed in float32, as the JAX package's."""
    f32 = np.float32
    total, warm = f32(total_iters), f32(warmup_steps)

    def schedule(count: int) -> float:
        c = f32(count)
        if c < warm:
            return float(f32(start_lr) * (c / max(warm, f32(1.0))))
        frac = max(f32(1.0) - c / total, f32(0.0))
        poly = f32(start_lr) * np.power(frac, f32(lr_power))
        return float(np.clip(poly, f32(end_lr), f32(start_lr)))

    return schedule
