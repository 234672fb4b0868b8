"""The port's fused log-mel (K3) against the JAX package.

On the CPU the port's wrapper takes its plain version, which repeats the
CUDA kernel's arithmetic (framing and reflect padding, the 400 window rows
of the DFT bases, power, mel, dB, normalization). It is held against the
JAX Pallas kernel run in interpret mode, as tests/test_pallas_mel.py runs
it, and against the JAX package's unfused ``preprocess_audio``. Everything
is float32; the tolerance is 2e-6 on the [-1, 1] output scale, where a dB
is 0.01 (measured: 3e-7 and below; the sums of the three products are
taken in other orders).
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
from cavp_tpu_torch.ops.kernels.mel import fused_log_mel, fused_log_mel_reference
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
