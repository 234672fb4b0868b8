"""The port's fused log-mel (K3) against the JAX package.

On the CPU the port's wrapper takes its plain version, which repeats the
CUDA kernel's arithmetic (framing and reflect padding, the 400 window rows
of the DFT bases, power, mel, dB, normalization). It is held against the
JAX Pallas kernel run in interpret mode, as tests/test_pallas_mel.py runs
it, and against the JAX package's unfused ``preprocess_audio``. Everything
is float32; the tolerance is 2e-6 on the [-1, 1] output scale, where a dB
is 0.01 (measured: 3e-7 and below; the sums of the three products are
taken in other orders).

The CUDA kernel runs the DFT as split-TF32 tensor-core products over the
bins the filterbank uses (``mel_plan``). Its host plan is checked here, and
``fused_log_mel_emulated`` repeats its arithmetic. The tensor cores sum in
another order than a float32 matrix product, and on some inputs the float32
sum in sequence (the plain version's and the JAX kernel's) is itself more
than 2e-6 from the exact function (measured: 1.6e-5 at 5 x 96 frames of
noise, 4e-5 on a tone over a noise floor, where bands of leakage near the
1e-5 floor come from the cancellation of large terms). So the emulation,
the plain version and the JAX kernel are each held against the function in
float64 (``log_mel_float64``): within 2e-6, or, where the plain version is
itself further than that, within twice its distance plus 1e-7.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cavp_tpu.audio.mel import preprocess_audio as jax_preprocess_audio
from cavp_tpu.ops.pallas import mel_kernel as jax_mel_kernel
from cavp_tpu_torch.audio.mel import preprocess_audio
from cavp_tpu_torch.engine import loops
from cavp_tpu_torch.audio.mel import melscale_fbanks
from cavp_tpu_torch.ops.kernels.mel import (
    SPAN, TILE, _bases, frames_per_tile, fused_log_mel, fused_log_mel_emulated,
    fused_log_mel_reference, log_mel_float64, mel_plan, slab_layout)
from torch_port_common import release_after_module  # noqa: F401 (autouse)

ATOL = 2e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


def _wave(seed, rows, length=16000, amp=0.6):
    rng = np.random.RandomState(seed)
    return ((rng.rand(rows, length) - 0.5) * amp).astype(np.float32)


# rows x n_frames: 288 is a multiple of the CUDA kernel's 16-frame tile and
# of no JAX row tile (256); 5 x 96 and 1 x 7 are ragged for both
@pytest.mark.parametrize("rows,n_frames", [(3, 96), (5, 96), (1, 7)])
def test_plain_version_matches_the_jax_kernel(rows, n_frames):
    wave = _wave(rows, rows)
    ref = np.asarray(jax_mel_kernel.fused_log_mel(jnp.asarray(wave), n_frames=n_frames))
    got = fused_log_mel_reference(torch.from_numpy(wave), n_frames)
    assert got.shape == ref.shape == (rows, n_frames, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert np.abs(ref).max() < 1.0 and np.ptp(ref) > 0.05


def test_wrapper_matches_the_jax_unfused_path():
    wave = _wave(7, 6).reshape(3, 2, 16000)
    ref = np.asarray(jax_preprocess_audio(jnp.asarray(wave), n_frames=96))
    got = fused_log_mel(torch.from_numpy(wave).reshape(6, 16000), 96)
    np.testing.assert_allclose(got.reshape(3, 2, 96, 64).numpy(), ref, rtol=0, atol=ATOL)


def test_other_range_and_band_match_the_jax_kernel():
    wave = _wave(11, 2, length=48000, amp=1.5)
    kw = dict(n_frames=300, spec_min=-80.0, spec_max=20.0, f_min=60.0, f_max=7000.0)
    ref = np.asarray(jax_mel_kernel.fused_log_mel(jnp.asarray(wave), **kw))
    got = fused_log_mel(torch.from_numpy(wave), **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_silence_hits_the_floor():
    got = fused_log_mel(torch.zeros(2, 16000), 96)
    # 20 * log10(1e-5) = -100 dB, the bottom of the default range
    np.testing.assert_allclose(got.numpy(), -1.0, rtol=0, atol=1e-6)


def test_preprocess_audio_routes_to_the_kernel_wrapper():
    wave = torch.from_numpy(_wave(3, 4).reshape(2, 2, 16000))
    plain = preprocess_audio(wave, n_frames=96)
    fused = preprocess_audio(wave, n_frames=96, use_pallas=True)
    assert fused.shape == plain.shape == (2, 2, 96, 64)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(fused, fused_log_mel(wave.reshape(4, 16000), 96).reshape(2, 2, 96, 64))
    ref = np.asarray(jax_preprocess_audio(jnp.asarray(wave.numpy()), n_frames=96,
                                          use_pallas=True))
    np.testing.assert_allclose(fused.numpy(), ref, rtol=0, atol=ATOL)
    # the engine's wrapper keeps the JAX layout [N, T, 64, C]
    assert torch.equal(loops.preprocess_audio(wave, n_frames=96, use_pallas=True),
                       fused.permute(0, 2, 3, 1))


def test_wrapper_checks_its_input_and_never_falls_back():
    with pytest.raises(ValueError, match="float32"):
        fused_log_mel(torch.zeros(2, 16000, dtype=torch.bfloat16), 96)
    with pytest.raises(ValueError, match="frames"):
        fused_log_mel(torch.zeros(2, 16000), 102)
    with pytest.raises(ValueError, match="reflect"):
        fused_log_mel(torch.zeros(2, 200), 1)
    with pytest.raises(ValueError, match="rows, L"):
        fused_log_mel(torch.zeros(2, 1, 16000), 96)
    before = fused_log_mel.launches
    with pytest.raises(ValueError, match="no mel kernel"):
        fused_log_mel(torch.zeros(2, 16000, device="meta"), 96)
    fused_log_mel(torch.zeros(1, 16000), 96)  # the CPU takes the plain version
    assert fused_log_mel.launches == before


# ---- the CUDA kernel's plan and arithmetic ---------------------------------------


@pytest.mark.parametrize("f_min,f_max", [(125.0, 3800.0), (60.0, 7000.0), (0.0, 8000.0)])
def test_kernel_plan_holds_the_filterbank_and_the_bases(f_min, f_max):
    fb = melscale_fbanks(257, f_min, f_max, 64, 16000).astype(np.float32)
    p = mel_plan(f_min, f_max)
    used = np.flatnonzero(fb.any(axis=1))
    assert (p.k_lo, p.k_lo + p.n_bins) == (used[0], used[-1] + 1)
    # the sparse filterbank holds every nonzero weight exactly once
    dense = np.zeros_like(fb)
    for m in range(64):
        first, count, offset = p.bands[:, m]
        rows = slice(p.k_lo + first, p.k_lo + first + count)
        assert first >= 0 and first + count <= p.n_bins and not dense[rows, m].any()
        dense[rows, m] = p.weights[offset:offset + count]
    np.testing.assert_array_equal(dense, fb)
    # the pruned bases: bin i's cos and sin side by side, the dense columns
    wcos, wsin, _ = _bases(f_min, f_max)
    n = p.n_bins
    assert p.chunk_cols in (240, 256) and p.bases.shape == (400, p.chunks * p.chunk_cols)
    assert (p.chunk_cols == 240) == (p.chunks == 1 and 2 * n <= 240)
    np.testing.assert_array_equal(p.bases[:, 0:2 * n:2], wcos[:, p.k_lo:p.k_lo + n])
    np.testing.assert_array_equal(p.bases[:, 1:2 * n:2], wsin[:, p.k_lo:p.k_lo + n])
    assert not p.bases[:, 2 * n:].any()
    # the TF32 split, K-major: hi and lo keep 10 mantissa bits, and hi + lo is
    # each basis to 2^-21 relative
    assert p.hi.shape == p.lo.shape == p.bases.T.shape
    for half in (p.hi, p.lo):
        assert not (half.view(np.uint32) & 0x1FFF).any()
    err = np.abs(p.hi.T.astype(np.float64) + p.lo.T - p.bases)
    assert (err <= 2.0 ** -21 * np.abs(p.bases)).all()
    # as the kernel streams them: slabs of 32 samples, each column's 16-byte
    # pieces in 128-byte swizzle order
    slabs = slab_layout(p.hi)
    assert slabs.shape == (13, p.hi.shape[0], 32)
    pieces = slabs.reshape(13, -1, 8, 4)
    cols = np.arange(p.hi.shape[0])
    unswizzled = pieces[:, cols[:, None], np.arange(8)[None] ^ (cols[:, None] % 8)]
    k_major = unswizzled.transpose(1, 0, 2, 3).reshape(p.hi.shape[0], 416)
    np.testing.assert_array_equal(k_major[:, :400], p.hi)
    assert not k_major[:, 400:].any()


@pytest.mark.parametrize("n_frames", [1, 2, 7, 63, 96, 101])
def test_kernel_tiles_fit_the_staging_buffer(n_frames):
    def span(f):  # 160 samples a frame, 320 for every row f frames can touch
        return f * 160 + min(f, 1 + -(-(f - 1) // n_frames)) * 320

    f = frames_per_tile(n_frames)
    assert 1 <= f <= TILE and span(f) <= SPAN
    assert f == TILE or span(f + 1) > SPAN
    if n_frames >= 63:
        assert f == TILE


def _held_to_float64(got, f64, plain_err):
    """max |got - f64| within 2e-6, or within twice the plain version's
    distance plus 1e-7 where that is larger."""
    err = float(np.abs(np.asarray(got, np.float64) - f64).max())
    return err, err <= max(ATOL, 2 * plain_err + 1e-7)


# the inputs of the tests above: rows x frames of noise, and the other band
_NOISE = {"3x96": (3, 96, {}), "5x96": (5, 96, {}), "1x7": (1, 7, {}),
          "band": (2, 300, dict(spec_min=-80.0, spec_max=20.0, f_min=60.0, f_max=7000.0))}


@pytest.mark.parametrize("case", sorted(_NOISE))
def test_kernel_emulation_against_float64_beside_the_jax_kernel(case):
    rows, n_frames, kw = _NOISE[case]
    wave = _wave(11, rows, length=48000, amp=1.5) if case == "band" else _wave(rows, rows)
    w = torch.from_numpy(wave)
    f64 = log_mel_float64(w, n_frames, **kw).numpy()
    plain = fused_log_mel_reference(w, n_frames, **kw).numpy()
    plain_err = float(np.abs(plain - f64).max())
    emu = fused_log_mel_emulated(w, n_frames, **kw)
    assert emu.shape == (rows, n_frames, 64) and emu.dtype == torch.float32
    jax_out = np.asarray(jax_mel_kernel.fused_log_mel(jnp.asarray(wave), n_frames=n_frames, **kw))
    for name, got in (("emulation", emu.numpy()), ("jax kernel", jax_out)):
        err, ok = _held_to_float64(got, f64, plain_err)
        assert ok, f"{name}: {err:.3e} from float64, the plain version {plain_err:.3e}"


@pytest.mark.parametrize("f_min,f_max", [(125.0, 3800.0), (60.0, 7000.0)])
def test_kernel_emulation_on_a_tone_over_a_noise_floor(f_min, f_max):
    # a 1 kHz tone at 0.5 and noise at 1e-4: 100 dB between the tone's bins
    # and the floor, and leakage bands near the 1e-5 clamp
    rng = np.random.RandomState(17)
    t = np.arange(16000) / 16000.0
    wave = (0.5 * np.sin(2 * np.pi * 1000.0 * t)[None]
            + 1e-4 * rng.randn(3, 16000)).astype(np.float32)
    w = torch.from_numpy(wave)
    f64 = log_mel_float64(w, 96, f_min=f_min, f_max=f_max).numpy()
    plain = fused_log_mel_reference(w, 96, f_min=f_min, f_max=f_max).numpy()
    plain_err = float(np.abs(plain - f64).max())
    emu = fused_log_mel_emulated(w, 96, f_min=f_min, f_max=f_max).numpy()
    jax_out = np.asarray(jax_mel_kernel.fused_log_mel(jnp.asarray(wave), n_frames=96,
                                                      f_min=f_min, f_max=f_max))
    assert np.ptp(f64) > 1.0  # the tone's bands and the clamped floor
    for name, got in (("emulation", emu), ("jax kernel", jax_out)):
        err, ok = _held_to_float64(got, f64, plain_err)
        assert ok, f"{name}: {err:.3e} from float64, the plain version {plain_err:.3e}"
