"""The trainer log-mel frontend as one CUDA kernel, and its plain PyTorch
version.

Replaces the TPU kernel ``cavp_tpu/ops/pallas/mel_kernel.py``
(``fused_log_mel``): framing (hop 160, centre reflect padding) + Hann
window + real DFT + power + mel projection + dB + normalization to
[-1, 1], with no frame tensor and no power spectrum in device memory. The
kernel is ``csrc/mel_kernel.cu``; its source note gives the bound on the
H100 and the design: the DFT over only the bins the filterbank uses, as
split-TF32 ``wgmma`` products (each operand as a TF32 ``hi`` plus a TF32
``lo``, and ``hi.hi + hi.lo + lo.hi``), with a sparse mel epilogue.
:func:`mel_plan` is the host side of it.

Input and output are float32, as is the plain version
:func:`fused_log_mel_reference` (the bases are the port's own,
``audio/mel.py``; only the 400 rows under the window are kept). The
tensor cores sum in another order than a float32 matrix product, so the
kernel's bits are not the plain version's: both are held against
:func:`log_mel_float64`, the same function in float64, and the kernel is
held to 2e-6 on the [-1, 1] scale, or, where the plain version is itself
further than that, to twice the plain version's distance.
:func:`fused_log_mel_emulated` repeats the kernel's arithmetic on the CPU
for the tests.

:func:`fused_log_mel` takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from cavp_tpu_torch.audio.mel import (
    SAMPLE_RATE,
    _rdft_bases,
    melscale_fbanks,
    periodic_hann,
)

N_FFT = 512
WIN = 400
HOP = 160
N_MELS = 64
N_FREQS = N_FFT // 2 + 1
_LPAD = (N_FFT - WIN) // 2
_LN10 = 2.302585092994046
TILE = 64            # frames a tile: wgmma's M (csrc kRows)
SPAN = 99 * HOP      # waveform samples a tile may stage (csrc kSpanLogical)
SLAB = 32            # samples of a slab of the products (csrc kSlabK)


def _windowed_bases(dtype):
    """(wcos, wsin) [400, 257]: the Hann-weighted real-DFT bases under the
    window, in ``dtype``."""
    win = periodic_hann(WIN)
    cos_b, sin_b = _rdft_bases(N_FFT)
    rows = slice(_LPAD, _LPAD + WIN)
    return (cos_b[rows] * win[:, None]).astype(dtype), (sin_b[rows] * win[:, None]).astype(dtype)


@functools.lru_cache(maxsize=None)
def _bases(f_min: float, f_max: float):
    """(wcos, wsin) [400, 257] and fb [257, 64], float32 numpy."""
    wcos, wsin = _windowed_bases(np.float32)
    fb = melscale_fbanks(N_FREQS, f_min, f_max, N_MELS, SAMPLE_RATE).astype(np.float32)
    return wcos, wsin, fb


@functools.lru_cache(maxsize=None)
def _device_bases(f_min: float, f_max: float, device: torch.device):
    return tuple(torch.from_numpy(a).to(device).contiguous() for a in _bases(f_min, f_max))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class MelPlan:
    """The kernel's view of one band of the filterbank.

    Bins ``[k_lo, k_lo + n_bins)`` are the filterbank's nonzero rows.
    ``bases`` [400, chunks * chunk_cols] float32 holds bin i's windowed cos
    in column 2i and its sin in 2i + 1 (the dense bases' columns, zeros
    past the bins); ``hi`` and ``lo`` are its TF32 split, K-major
    ([columns, 400]). A chunk is 240 columns when the bins fit one, else
    256 (wgmma's widest N is 256). ``bands`` [3, 64] int32 gives each
    band's first bin (counted from k_lo), its bin count and its offset in
    ``weights``: the filterbank's triangles are contiguous, so this holds
    every nonzero weight once."""

    k_lo: int
    n_bins: int
    chunk_cols: int
    chunks: int
    bases: np.ndarray
    hi: np.ndarray
    lo: np.ndarray
    bands: np.ndarray
    weights: np.ndarray


@functools.lru_cache(maxsize=None)
def mel_plan(f_min: float, f_max: float) -> MelPlan:
    wcos, wsin, fb = _bases(f_min, f_max)
    used = np.flatnonzero(fb.any(axis=1))
    k_lo = int(used[0]) if used.size else 0
    n_bins = int(used[-1]) + 1 - k_lo if used.size else 0
    chunk_cols = 240 if 2 * n_bins <= 240 else 256
    chunks = max(1, -(-2 * n_bins // chunk_cols))
    bases = np.zeros((WIN, chunks * chunk_cols), np.float32)
    bases[:, 0:2 * n_bins:2] = wcos[:, k_lo:k_lo + n_bins]
    bases[:, 1:2 * n_bins:2] = wsin[:, k_lo:k_lo + n_bins]
    b = torch.from_numpy(bases)
    hi = tf32_rna(b)
    lo = tf32_rna(b - hi)
    bands = np.zeros((3, N_MELS), np.int32)
    weights = []
    for m in range(N_MELS):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            assert nz[-1] - nz[0] + 1 == nz.size, "a mel band's bins are not contiguous"
            bands[:, m] = nz[0] - k_lo, nz.size, sum(map(len, weights))
            weights.append(fb[nz, m])
    weights = np.concatenate(weights) if weights else np.zeros(1, np.float32)
    return MelPlan(k_lo, n_bins, chunk_cols, chunks, bases, hi.T.contiguous().numpy(),
                   lo.T.contiguous().numpy(), bands, weights.astype(np.float32))


def slab_layout(bt: np.ndarray) -> np.ndarray:
    """K-major bases [columns, 400] as the kernel streams them: slabs of 32
    samples ([13, columns, 32], zeros past sample 400), each column's
    128-byte row cut in eight 16-byte pieces and piece j stored at
    j ^ (column % 8), the 128-byte swizzle that ``wgmma`` reads (a slab's
    rows land 1024-byte aligned, so it is the global column's residue)."""
    cols = bt.shape[0]
    slabs = -(-WIN // SLAB)
    k = np.zeros((cols, slabs * SLAB), np.float32)
    k[:, :WIN] = bt
    x = k.reshape(cols, slabs, SLAB // 4, 4)
    out = np.empty_like(x)
    for r in range(8):
        out[r::8, :, np.arange(8) ^ r] = x[r::8]
    return np.ascontiguousarray(out.transpose(1, 0, 2, 3).reshape(slabs, cols, SLAB))


@functools.lru_cache(maxsize=None)
def _device_plan(f_min: float, f_max: float, device: torch.device):
    p = mel_plan(f_min, f_max)
    return tuple(torch.from_numpy(a).to(device).contiguous()
                 for a in (slab_layout(p.hi), slab_layout(p.lo), p.bands, p.weights))


@functools.lru_cache(maxsize=None)
def frames_per_tile(n_frames: int) -> int:
    """Frames a kernel tile takes: 64, unless rows of fewer frames let 64
    consecutive frames touch so many rows that their waveform spans (160
    samples a frame and 320 a row) outgrow the kernel's staging buffer."""
    rows = lambda f: min(f, 1 + -(-(f - 1) // n_frames))
    return next(f for f in range(TILE, 0, -1) if f * HOP + rows(f) * 2 * HOP <= SPAN)


def _check(wave: torch.Tensor, n_frames: int) -> None:
    if wave.dim() != 2:
        raise ValueError(f"need a waveform [rows, L], got {tuple(wave.shape)}")
    if wave.dtype != torch.float32:
        raise ValueError(f"the mel frontend is float32, got {wave.dtype}")
    L = wave.shape[1]
    if L <= N_FFT // 2:
        raise ValueError(f"reflect padding needs more than {N_FFT // 2} samples, got {L}")
    if not 0 < n_frames <= 1 + L // HOP:
        raise ValueError(f"{L} samples give {1 + L // HOP} frames, asked for {n_frames}")


def _frames(wave: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[rows, n_frames, 400]: the window's samples of each frame."""
    pad = N_FFT // 2
    x = torch.nn.functional.pad(wave.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)
    return x.unfold(-1, N_FFT, HOP)[:, :n_frames, _LPAD:_LPAD + WIN]


def _normalize(mel: torch.Tensor, spec_min: float, spec_max: float) -> torch.Tensor:
    db = 20.0 * (torch.log(torch.clamp(mel, min=1e-5)) / _LN10)
    half, mid = (spec_max - spec_min) / 2.0, (spec_max + spec_min) / 2.0
    return (db - mid) * (1.0 / half)


def fused_log_mel_reference(wave: torch.Tensor, n_frames: int,
                            spec_min: float = -100.0, spec_max: float = 100.0,
                            f_min: float = 125.0, f_max: float = 3800.0) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_log_mel`, on any device."""
    _check(wave, n_frames)
    frames = _frames(wave, n_frames)
    wcos, wsin, fb = _device_bases(f_min, f_max, wave.device)
    re, im = frames @ wcos, frames @ wsin
    return _normalize((re * re + im * im) @ fb, spec_min, spec_max)


def log_mel_float64(wave: torch.Tensor, n_frames: int,
                    spec_min: float = -100.0, spec_max: float = 100.0,
                    f_min: float = 125.0, f_max: float = 3800.0) -> torch.Tensor:
    """The same function in float64, on the float32 waveform, with float64
    bases and filterbank: the yardstick the kernel and the plain version are
    held against."""
    _check(wave, n_frames)
    frames = _frames(wave.double(), n_frames)
    wcos, wsin = (torch.from_numpy(a).to(wave.device) for a in _windowed_bases(np.float64))
    fb = torch.from_numpy(melscale_fbanks(N_FREQS, f_min, f_max, N_MELS, SAMPLE_RATE))
    re, im = frames @ wcos, frames @ wsin
    return _normalize((re * re + im * im) @ fb.to(wave.device), spec_min, spec_max)


def fused_log_mel_emulated(wave: torch.Tensor, n_frames: int,
                           spec_min: float = -100.0, spec_max: float = 100.0,
                           f_min: float = 125.0, f_max: float = 3800.0) -> torch.Tensor:
    """The CUDA kernel's arithmetic in plain PyTorch, for the tests: the
    plan's bins, each operand split into TF32 hi and lo (``cvt.rna``), the
    three products hi.lo + lo.hi + hi.hi summed over each slab of 32
    samples (each product exact in float32; the tensor cores sum a slab in
    their own order and round toward zero), the slabs' sums added in order
    in float32, power, and the sparse mel of each band over its bins in
    ascending order with a fused multiply-add."""
    _check(wave, n_frames)
    p = mel_plan(f_min, f_max)
    frames = _frames(wave, n_frames).contiguous()
    ah = tf32_rna(frames)
    al = tf32_rna(frames - ah)
    bh, bl = (torch.from_numpy(a.T.copy()).to(wave.device) for a in (p.hi, p.lo))
    acc = None
    for k in range(0, WIN, SLAB):
        s = slice(k, k + SLAB)
        part = ah[..., s] @ bl[s] + al[..., s] @ bh[s] + ah[..., s] @ bh[s]
        acc = part if acc is None else acc + part
    re, im = acc[..., 0:2 * p.n_bins:2], acc[..., 1:2 * p.n_bins:2]
    power = (re * re + im * im).double()
    first, count, offset = (torch.from_numpy(a.astype(np.int64)) for a in p.bands)
    weights = torch.from_numpy(p.weights).double()
    mel = torch.zeros(power.shape[:-1] + (N_MELS,), dtype=torch.float32, device=wave.device)
    for j in range(int(count.max()) if p.n_bins else 0):
        live = j < count
        b = torch.where(live, first + j, 0).to(wave.device)
        w = torch.where(live, weights[torch.where(live, offset + j, 0)], 0.0).to(wave.device)
        # fmaf: the product and the sum rounded once (float64 holds the product exactly)
        mel = (mel.double() + power[..., b] * w).float()
    return _normalize(mel, spec_min, spec_max)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with the C signatures declared."""
    from cavp_tpu_torch.ops._build import load_library

    lib = load_library()
    fn = lib.cavp_fused_log_mel
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cavp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cavp_cuda_error_string.restype = ctypes.c_char_p
    return lib


@torch.no_grad()
def fused_log_mel(wave: torch.Tensor, n_frames: int,
                  spec_min: float = -100.0, spec_max: float = 100.0,
                  f_min: float = 125.0, f_max: float = 3800.0) -> torch.Tensor:
    """[rows, L] float32 16 kHz waveform -> [rows, n_frames, 64] log-mel,
    normalized from [spec_min, spec_max] dB to [-1, 1].

    CPU tensors take :func:`fused_log_mel_reference`; CUDA tensors launch
    the kernel (counted in ``fused_log_mel.launches``) or raise.
    """
    _check(wave, n_frames)
    if wave.device.type == "cpu":
        return fused_log_mel_reference(wave, n_frames, spec_min, spec_max, f_min, f_max)
    if wave.device.type != "cuda":
        raise ValueError(f"no mel kernel for device {wave.device}")
    if not wave.is_contiguous():
        raise ValueError("the waveform must be contiguous")
    rows, L = wave.shape
    lib = _library()
    plan = mel_plan(f_min, f_max)
    hi, lo, bands, weights = _device_plan(f_min, f_max, wave.device)
    out = torch.empty(rows, n_frames, N_MELS, dtype=torch.float32, device=wave.device)
    half, mid = (spec_max - spec_min) / 2.0, (spec_max + spec_min) / 2.0
    err = lib.cavp_fused_log_mel(
        wave.data_ptr(), hi.data_ptr(), lo.data_ptr(), bands.data_ptr(), weights.data_ptr(),
        out.data_ptr(), rows, L, n_frames, frames_per_tile(n_frames), plan.chunks,
        plan.chunk_cols, mid, 1.0 / half, torch.cuda.current_stream(wave.device).cuda_stream)
    if err != 0:
        msg = lib.cavp_cuda_error_string(err).decode()
        raise RuntimeError(f"mel kernel launch failed: {msg} ({err})")
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0
