"""Trainer log-mel frontend (``cavp_tpu/audio/mel.py``).

torchaudio ``MelSpectrogram(16000, n_fft=512, win=400, hop=160, 64 mels,
125-3800 Hz)`` parity: center reflect padding, a periodic Hann window of
400 centred in the 512-sample frame, the real DFT as two matmuls against
cos/sin bases, power spectrum, HTK mel filterbank (norm=None), then dB
and normalization to [-1, 1]. The DFT and mel matmuls always run in
float32, also when the model computes in bf16: the dB of a power
spectrum is too sensitive for bf16 bases.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cavp_tpu_torch.audio.functional import db_from_amp, normalize_spec

SAMPLE_RATE = 16000


def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic Hann window (``torch.hann_window`` default)."""
    return 0.5 - 0.5 * np.cos(
        2.0 * np.pi / window_length * np.arange(window_length))


@functools.lru_cache(maxsize=None)
def _rdft_bases(n_fft: int) -> tuple:
    """Real-DFT cosine/sine bases of shape [n_fft, n_fft//2+1]."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang), -np.sin(ang)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels], torchaudio semantics
    (mel_scale="htk", norm=None): triangles linear in the Hz domain
    between mel-spaced edge frequencies."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up))


@functools.lru_cache(maxsize=None)
def _mel_operators(n_fft: int, win_length: int, n_mels: int, f_min: float,
                   f_max: float) -> tuple:
    """Windowed cos/sin bases [n_fft, n_fft//2+1] and the filterbank
    [n_fft//2+1, n_mels], float32 numpy."""
    win_full = np.zeros(n_fft)
    lpad = (n_fft - win_length) // 2
    win_full[lpad:lpad + win_length] = periodic_hann(win_length)
    cos_b, sin_b = _rdft_bases(n_fft)
    fb = melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels, SAMPLE_RATE)
    return ((cos_b * win_full[:, None]).astype(np.float32),
            (sin_b * win_full[:, None]).astype(np.float32),
            fb.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _mel_operators_on(device: torch.device, *args) -> tuple:
    """:func:`_mel_operators` as tensors on ``device``, uploaded once: a
    copy from pageable host memory to the card on every call would make
    the host wait for the device each time. Made outside inference mode,
    so the train step may use them too."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device) for a in _mel_operators(*args))


def mel_spectrogram(wave: torch.Tensor, *, n_fft: int = 512,
                    win_length: int = 400, hop_length: int = 160,
                    n_mels: int = 64, f_min: float = 125.0,
                    f_max: float = 3800.0) -> torch.Tensor:
    """Power mel spectrogram: [R, L] float32 -> [R, n_mels, T]."""
    pad = n_fft // 2
    x = F.pad(wave.float().unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)
    frames = x.unfold(-1, n_fft, hop_length)  # [R, T, n_fft]
    wcos, wsin, fb = _mel_operators_on(wave.device, n_fft, win_length, n_mels, f_min, f_max)
    re = frames @ wcos
    im = frames @ wsin
    mel = (re * re + im * im) @ fb  # [R, T, n_mels]
    return mel.transpose(-1, -2)


def preprocess_audio(wave: torch.Tensor, *, n_frames: int,
                     spec_min: float = -100.0, spec_max: float = 100.0,
                     use_pallas: bool = False) -> torch.Tensor:
    """The trainer's audio pipeline: [N, C, L] -> [N, C, T, 64] float32.

    mel -> truncate to ``n_frames`` -> transpose -> dB -> normalize to
    [-1, 1] (``cavp_tpu.audio.mel.preprocess_audio``). ``use_pallas``
    (the JAX package's name for it) takes the fused kernel of
    :mod:`cavp_tpu_torch.ops.kernels.mel` instead."""
    N, C, L = wave.shape
    if use_pallas:
        from cavp_tpu_torch.ops.kernels.mel import fused_log_mel  # imports this module
        out = fused_log_mel(wave.reshape(N * C, L).float().contiguous(), n_frames=n_frames,
                            spec_min=spec_min, spec_max=spec_max)
        return out.reshape(N, C, n_frames, out.shape[-1])
    mel = mel_spectrogram(wave.reshape(N * C, L))[:, :, :n_frames]
    mel = normalize_spec(db_from_amp(mel.transpose(-1, -2)), spec_min, spec_max)
    return mel.reshape(N, C, n_frames, mel.shape[-1])
