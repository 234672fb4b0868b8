"""The port's fusion kernel wrapper against the JAX package's Pallas kernel.

``cavp_tpu_torch.ops.kernels.fusion`` holds the CUDA kernel's wrapper and
its plain PyTorch version; on the CPU the wrapper takes the plain
version. Both it and the port's module path (``CAVP.forward_fusion``)
are held against ``cavp_tpu.ops.pallas.fusion_kernel.fused_visual_fusion``
run in interpret mode, on the same weights and inputs made from numpy
seeds, at C = 304 with an aligned (8x8) and a ragged (7x9) token count.

Tolerance (f32): rtol 1e-4 / atol 5e-5, as tests/test_pallas_fusion.py —
the Pallas kernel's rational erf is within 1.5e-7 of exact erf, which
fc2 and the MLP sums amplify to a few e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from cavp_tpu.ops.pallas import fusion_kernel as jax_fusion
from cavp_tpu_torch.engine.convert import state_dict_from_jax
from cavp_tpu_torch.models.attn import CrossAttention
from cavp_tpu_torch.models.cavp import CAVP
from cavp_tpu_torch.models.layers import Mlp
from cavp_tpu_torch.ops import _build
from cavp_tpu_torch.ops.kernels import fusion

TOL = dict(rtol=1e-4, atol=5e-5)
C = 304


def _jax_fusion_params(c: int, seed: int):
    """JAX-layout ``visual_projector`` + ``cross_att`` params from numpy,
    with the LayerNorm affines and biases perturbed off 1/0 so that a
    swapped or dropped term shows."""
    rng = np.random.RandomState(seed)
    dense = lambda i, o, bias=True: dict(
        kernel=rng.uniform(-1, 1, (i, o)).astype(np.float32) / np.sqrt(i),
        **({"bias": rng.normal(0, 0.1, o).astype(np.float32)} if bias else {}))
    ln = lambda: dict(scale=(1 + 0.2 * rng.randn(c)).astype(np.float32),
                      bias=(0.1 * rng.randn(c)).astype(np.float32))
    return {
        "visual_projector": {"fc1": dense(c, 256), "fc2": dense(256, c)},
        "cross_att": {
            "patch_embed_v": {"proj": dense(c, c)},
            "patch_embed_a": {"proj": dense(c, c)},
            "pos_embed_v": np.zeros((1, 128 * 128, c), np.float32),
            "pos_embed_a": np.zeros((1, 1, c), np.float32),
            "block0": {
                "norm1": ln(), "norm2": ln(),
                "attn": {"q": dense(c, c, False), "k": dense(c, c, False),
                         "v": dense(c, c, False), "proj": dense(c, c)},
                "mlp": {"fc1": dense(c, 4 * c), "fc2": dense(4 * c, c)},
            },
            "norm": ln(),
        },
    }


class FusionSlice(nn.Module):
    """The two submodules ``CAVP.forward_fusion`` reads, so that the
    port's own method runs without building the towers."""

    forward_fusion = CAVP.forward_fusion

    def __init__(self, c: int):
        super().__init__()
        self.visual_projector = Mlp(c, 256, c)
        self.cross_att = CrossAttention(c)


@pytest.fixture(scope="module")
def weights():
    params = _jax_fusion_params(C, seed=0)
    port = FusionSlice(C).eval()
    port.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    return params, port


def _inputs(b, h, w, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, C).astype(np.float32),
            rng.randn(b, C).astype(np.float32))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_wrapper_on_cpu_matches_jax_kernel(weights, hw):
    params, port = weights
    fea_v, fea_a = _inputs(2, *hw)
    ref = np.asarray(jax_fusion.fused_visual_fusion(
        params, jnp.asarray(fea_v), jnp.asarray(fea_a), interpret=True))
    launches = fusion.fused_visual_fusion.launches
    tokens = torch.from_numpy(fea_v).reshape(2, hw[0] * hw[1], C)
    got = fusion.fused_visual_fusion(port, tokens, torch.from_numpy(fea_a))
    assert fusion.fused_visual_fusion.launches == launches == 0
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_module_path_matches_jax_kernel(weights, hw):
    params, port = weights
    fea_v, fea_a = _inputs(2, *hw, seed=2)
    ref = np.asarray(jax_fusion.fused_visual_fusion(
        params, jnp.asarray(fea_v), jnp.asarray(fea_a), interpret=True))
    with torch.no_grad():
        fused, pack = port.forward_fusion(
            torch.from_numpy(fea_v).permute(0, 3, 1, 2), torch.from_numpy(fea_a))
    assert pack["attn_v"].shape == (2, 4, hw[0] * hw[1], 1)
    got = fused.permute(0, 2, 3, 1).reshape(ref.shape).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_bf16_reference_tracks_f32(weights):
    """The bf16 rounding points of the plain version (the path the card
    compares its kernel against) stay within bf16 error of f32: outputs
    reach |y| ~ 5, where one bf16 ulp is 0.03; the chain's roundings give
    a max near 2 ulps (0.06 seen) and a mean near 0.004."""
    _, port = weights
    fea_v, fea_a = _inputs(1, 8, 8, seed=3)
    tokens = torch.from_numpy(fea_v).reshape(1, 64, C)
    a = torch.from_numpy(fea_a)
    f32 = fusion.fused_visual_fusion_reference(port, tokens, a)
    bf16 = fusion.fused_visual_fusion_reference(port, tokens.bfloat16(), a)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), rtol=0, atol=0.1)
    assert float((bf16.float() - f32).abs().mean()) < 0.01


def test_wrapper_never_falls_back_off_the_cpu(weights):
    _, port = weights
    tokens = torch.empty(2, 64, C, device="meta")
    with pytest.raises(ValueError, match="no fusion kernel"):
        fusion.fused_visual_fusion(port, tokens, torch.empty(2, C, device="meta"))
    with pytest.raises(ValueError, match="heads"):
        fusion.fused_visual_fusion(port, torch.zeros(1, 4, 6), torch.zeros(1, 6))
    with pytest.raises(ValueError, match="tokens"):
        fusion.fused_visual_fusion(port, torch.zeros(2, 4, C), torch.zeros(3, C))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Where no nvcc exists the CUDA path raises instead of running."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library()
    assert not (tmp_path / "build").exists()
    assert _build.library_path().name.startswith("libcavp_kernels_")
