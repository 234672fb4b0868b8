"""Scalar audio transforms: dB from amplitude and [-1, 1] spectrogram
normalization (``cavp_tpu/audio/functional.py``, reference
``utils/sourcesep.py:27-60``)."""

from __future__ import annotations

import torch

_LN10 = 2.302585092994046  # ln(10)


def db_from_amp(x: torch.Tensor, floor: float = 1e-5) -> torch.Tensor:
    """20*log10(max(floor, x)), as ``log(x) / ln(10)`` like the JAX
    version. The reference feeds it the *power* mel spectrogram."""
    return 20.0 * (torch.log(torch.clamp(x, min=floor)) / _LN10)


def normalize_spec(spec: torch.Tensor, spec_min: float, spec_max: float
                   ) -> torch.Tensor:
    """Map [spec_min, spec_max] to [-1, 1] (``sourcesep.normalize_spec``)."""
    return 2.0 * (spec - spec_min) / float(spec_max - spec_min) - 1.0
