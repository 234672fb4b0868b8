"""Serving-oriented inference API (``cavp_tpu/engine/predictor.py``).

Fixed batch buckets with padding, chunking of large requests, numpy in
and out, the trainer mel from raw waveforms on the device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from cavp_tpu_torch.config.setups import Config
from cavp_tpu_torch.engine.loops import make_inference_forward, preprocess_audio
from cavp_tpu_torch.engine.runner import build_model


def run_chunked(forward_batch, batch_sizes, img_shape, wav_shape,
                images: np.ndarray, waveforms: np.ndarray
                ) -> Dict[str, np.ndarray]:
    """Padding-safe serving loop: validates the request's shapes, pads
    each chunk up to a bucket, slices the padding back off and
    reassembles per key.

    ``forward_batch(img, wav) -> {name: np.ndarray [bucket, ...]}`` for
    exactly-bucket-sized inputs. Off-config shapes are rejected, so the
    served shapes stay the warmed ones."""
    if images.shape[0] == 0:
        raise ValueError("empty batch")
    if images.shape[0] != waveforms.shape[0]:
        raise ValueError(f"{images.shape[0]} images but "
                         f"{waveforms.shape[0]} waveforms")
    if tuple(images.shape[1:]) != tuple(img_shape):
        raise ValueError(f"image shape {tuple(images.shape[1:])} != "
                         f"compiled {tuple(img_shape)}")
    if tuple(waveforms.shape[1:]) != tuple(wav_shape):
        raise ValueError(f"waveform shape {tuple(waveforms.shape[1:])} != "
                         f"compiled {tuple(wav_shape)}")
    buckets = sorted(batch_sizes)
    n = images.shape[0]
    outs: Dict[str, list] = {}
    start = 0
    while start < n:
        chunk = min(n - start, buckets[-1])
        bucket = next(b for b in buckets if chunk <= b)
        img = np.zeros((bucket,) + images.shape[1:], images.dtype)
        wav = np.zeros((bucket,) + waveforms.shape[1:], waveforms.dtype)
        img[:chunk] = images[start:start + chunk]
        wav[:chunk] = waveforms[start:start + chunk]
        for k, v in forward_batch(img, wav).items():
            outs.setdefault(k, []).append(np.asarray(v)[:chunk])
        start += chunk
    return {k: np.concatenate(v) for k, v in outs.items()}


class Predictor:
    """Batched sounding-object segmentation inference.

    Example:
        p = Predictor(config, device="cuda", batch_sizes=(8,)).warmup()
        masks = p.predict(images_uint8, waveforms)["mask"]   # [N, H, W] int32

    Without ``state_dict`` the weights are drawn from ``config.seed``;
    with one (reference names, e.g. from
    :func:`cavp_tpu_torch.engine.convert.state_dict_from_jax`) it is
    loaded strictly.
    """

    def __init__(self, config: Config, device="cpu",
                 batch_sizes: Sequence[int] = (8,),
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        self.config = config
        self.device = torch.device(device)
        self.batch_sizes = sorted(batch_sizes)
        self.model = build_model(config, self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self._mean = torch.tensor(config.image_mean, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(config.image_std, dtype=torch.float32,
                                 device=self.device)
        self._infer = make_inference_forward(self.model, config)
        self._warmed = False

    @torch.inference_mode()
    def _forward_batch(self, images: np.ndarray, waveforms: np.ndarray
                       ) -> Dict[str, np.ndarray]:
        cfg = self.config
        img = torch.from_numpy(images).to(self.device)
        img = (img.float() / 255.0 - self._mean) / self._std
        wav = torch.from_numpy(waveforms).to(self.device)
        audio = preprocess_audio(wav, n_frames=cfg.mel_frames,
                                 spec_min=cfg.spec_min, spec_max=cfg.spec_max)
        pred = self._infer(img, audio).argmax(-1).to(torch.int32)
        return {"mask": pred.cpu().numpy()}

    def warmup(self) -> "Predictor":
        """Run every batch bucket once through the full ``predict`` path.
        Idempotent."""
        if not self._warmed:
            (h, w, c), (cin, length) = self.expected_shapes()
            for b in self.batch_sizes:
                self.predict(np.zeros((b, h, w, c), np.uint8),
                             np.zeros((b, cin, length), np.float32))
            self._warmed = True
        return self

    def expected_shapes(self) -> Tuple[Tuple[int, int, int], Tuple[int, int]]:
        """((H, W, 3), (Cin, L)) this predictor accepts."""
        return ((self.config.image_height, self.config.image_width, 3),
                (self.config.in_plane, self.config.audio_samples))

    def predict(self, images: np.ndarray, waveforms: np.ndarray
                ) -> Dict[str, np.ndarray]:
        """images: [N, H, W, 3] uint8; waveforms: [N, Cin, L] float32
        (16 kHz). Returns {"mask": [N, H, W] int32}. Requests larger
        than the biggest bucket are chunked (:func:`run_chunked`)."""
        img_shape, wav_shape = self.expected_shapes()
        return run_chunked(self._forward_batch, self.batch_sizes, img_shape,
                           wav_shape, images, waveforms)
