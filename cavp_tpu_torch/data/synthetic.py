"""In-memory synthetic eval batch with a setup's exact shapes
(``cavp_tpu/data/synthetic.py`` ``synthetic_eval_batch``), numpy only."""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_eval_batch(config, num_frames: int, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Flat eval batch ([N frames]) with a validity mask; the same draws
    as the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    H, W = config.image_height, config.image_width
    N = num_frames
    return {
        "image": rng.randn(N, H, W, 3).astype(np.float32),
        "waveform": (rng.rand(N, config.in_plane, config.audio_samples)
                     .astype(np.float32) - 0.5) * 0.2,
        "pix_label": rng.randint(0, config.num_classes, (N, H, W)).astype(np.int32),
        "valid": np.ones((N,), np.float32),
    }
