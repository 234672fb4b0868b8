"""Host-side audio IO (``cavp_tpu/data/audio_io.py``).

The loader's audio path of the reference
(``dataset/avss/audio/audio_dataset.py:31-65``): wav decode, resample to
16 kHz, center-crop or tile to ``audio_len`` seconds, mono mean; and the
VPO datasets' stereo synthesis, amplitude panning and the mixture of
several sources (``dataset/vpo_stereo/*/audio/audio_dataset.py:51-71``).
Stdlib ``wave`` and scipy's polyphase resampler, numpy out.
"""

from __future__ import annotations

import wave as wave_mod
from math import gcd
from typing import Tuple

import numpy as np
from scipy.signal import resample_poly

TARGET_SR = 16000


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (waveform [channels, samples] float32 in [-1,1], sr)."""
    with wave_mod.open(path, "rb") as f:
        sr = f.getframerate()
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")
    return data.reshape(-1, n_channels).T, sr


def resample(wave: np.ndarray, sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    if sr == target_sr:
        return wave
    g = gcd(sr, target_sr)
    return resample_poly(wave, target_sr // g, sr // g, axis=-1).astype(np.float32)


def crop_audio(wave: np.ndarray, audio_len: float, sr: int = TARGET_SR) -> np.ndarray:
    """Center-crop to audio_len seconds, tiling when short
    (audio_dataset.crop_audio:51-62).

    As the reference's python slicing does: when the clip is shorter than
    audio_len, ``st`` goes negative and ``wave[:, st:et]`` wraps from the
    end, so only the last ``-st`` samples are kept and tiled.
    """
    mid = wave.shape[-1] // 2
    sample_len = int(audio_len * sr)
    st = mid - sample_len // 2
    et = st + sample_len
    out = wave[..., st:et]  # a negative st wraps, as in the reference
    if out.shape[-1] != sample_len:
        reps = sample_len // max(out.shape[-1], 1) + 1
        out = np.tile(out, (1,) * (out.ndim - 1) + (reps,))[..., :sample_len]
    return out


def load_audio(path: str, audio_len: float) -> np.ndarray:
    """The whole loader path: [1, L], the mean of the channels."""
    wave, sr = load_wav(path)
    wave = resample(wave, sr)
    wave = crop_audio(wave, audio_len)
    return np.mean(wave, axis=0, keepdims=True).astype(np.float32)


def pan_stereo(wave: np.ndarray, position: float, weight: float = 1.0) -> np.ndarray:
    """[2, L] amplitude panning of the mono mean: left ``w (1 - pos)``,
    right ``w pos``
    (``dataset/vpo_stereo/single_source/audio/audio_dataset.py:57-68``)."""
    mono = wave.mean(axis=0) if wave.ndim == 2 else wave
    left = weight * (1.0 - position) * mono
    right = weight * position * mono
    return np.stack([left, right]).astype(np.float32)


def mix_sources(waves) -> np.ndarray:
    """The sum of several panned or mono sources, in order, as float32
    (``dataset/vpo_stereo/multi_source/audio/audio_dataset.py:51-71``)."""
    out = np.zeros_like(waves[0])
    for w in waves:
        out = out + w
    return out.astype(np.float32)
