"""In-memory synthetic batches with a setup's exact shapes
(``cavp_tpu/data/synthetic.py`` ``synthetic_train_batch`` and
``synthetic_eval_batch``), numpy only."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def synthetic_train_batch(config, batch_size: Optional[int] = None, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """Random train batch: image [B,H,W,3], waveform [B,Ca,L], pix_label
    [B,H,W], img_label [B,classes] multi-hot (background plus one source
    class per sample); the same draws as the JAX package's for the same
    seed."""
    rng = np.random.RandomState(seed)
    B = batch_size or config.batch_size
    H, W = config.image_height, config.image_width
    C = config.num_classes
    batch = {
        "image": rng.randn(B, H, W, 3).astype(np.float32),
        "waveform": (rng.rand(B, config.in_plane, config.audio_samples)
                     .astype(np.float32) - 0.5) * 0.2,
        "pix_label": rng.randint(0, C, (B, H, W)).astype(np.int32),
        "img_label": np.zeros((B, C), np.int32),
    }
    batch["img_label"][:, 0] = 1
    for i in range(B):
        batch["img_label"][i, 1 + i % (C - 1)] = 1
    return batch


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
