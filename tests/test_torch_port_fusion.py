"""The port's fusion kernel wrapper against the JAX package's Pallas kernel.

``cavp_tpu_torch.ops.kernels.fusion`` holds the CUDA kernel's wrapper and
its plain PyTorch version; on the CPU the wrapper takes the plain
version. Both it and the port's module path (``CAVP.forward_fusion``)
are held against ``cavp_tpu.ops.pallas.fusion_kernel.fused_visual_fusion``
run in interpret mode, on the same weights and inputs made from numpy
seeds, at C = 304 with an aligned (8x8) and a ragged (7x9) token count,
and the wrapper at the HRNet and OCR features' C = 720 and 512 (a few
tokens, float32 and bf16).

Tolerance (f32): rtol 1e-4 / atol 5e-5, as tests/test_pallas_fusion.py —
the Pallas kernel's rational erf is within 1.5e-7 of exact erf, which
fc2 and the MLP sums amplify to a few e-5. bf16: both sides round at the
same points, so they differ where a float sum or the erf lands on the
other side of a rounding boundary: at most 2 bf16 ulps of the output
(|y| < 8: 0.0625) and a mean below 5e-3 (3.3e-3 seen at C = 720, a
tenth of an ulp).
"""

import re
from pathlib import Path

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
from cavp_tpu_torch.ops.kernels import fusion_train as ft
from torch_port_common import release_after_module  # noqa: F401 (autouse)

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


def _weights_at(c):
    params = _jax_fusion_params(c, seed=0)
    port = FusionSlice(c).eval()
    port.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    return params, port


@pytest.fixture(scope="module")
def weights():
    return _weights_at(C)


def _inputs(b, h, w, seed=1, c=C):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, c).astype(np.float32))


# the case ids of C = 304 are those the cases had before the zoo's widths
@pytest.mark.parametrize("c, hw, dtype", [
    pytest.param(C, (8, 8), "float32", id="hw0"),
    pytest.param(C, (7, 9), "float32", id="hw1"),
    pytest.param(720, (3, 5), "float32", id="c720"),
    pytest.param(512, (3, 5), "float32", id="c512"),
    pytest.param(720, (3, 5), "bfloat16", id="c720_bf16"),
    pytest.param(512, (3, 5), "bfloat16", id="c512_bf16"),
])
def test_wrapper_on_cpu_matches_jax_kernel(weights, c, hw, dtype):
    params, port = weights if c == C else _weights_at(c)
    fea_v, fea_a = _inputs(2, *hw, c=c)
    ref = np.asarray(jax_fusion.fused_visual_fusion(
        params, jnp.asarray(fea_v, dtype), jnp.asarray(fea_a, dtype),
        interpret=True).astype(jnp.float32))
    launches = fusion.fused_visual_fusion.launches
    tdt = getattr(torch, dtype)
    tokens = torch.from_numpy(fea_v).reshape(2, hw[0] * hw[1], c).to(tdt)
    got = fusion.fused_visual_fusion(port, tokens, torch.from_numpy(fea_a).to(tdt))
    assert fusion.fused_visual_fusion.launches == launches == 0
    assert got.shape == ref.shape and got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    else:
        err = np.abs(got.float().numpy() - ref)
        assert np.abs(ref).max() < 8 and err.max() <= 0.0625 and err.mean() < 5e-3, (
            err.max(), err.mean())


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


# ---- the weight-operand cache of fusion_operands ----------------------------

def _slice_from(params):
    port = FusionSlice(C).eval()
    port.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    return port


def _jax_ref(params, fea_v, fea_a):
    return np.asarray(jax_fusion.fused_visual_fusion(
        params, jnp.asarray(fea_v), jnp.asarray(fea_a), interpret=True))


def _port_out(port, fea_v, fea_a):
    b, h, w, _ = fea_v.shape
    tokens = torch.from_numpy(fea_v).reshape(b, h * w, C)
    return fusion.fused_visual_fusion(port, tokens, torch.from_numpy(fea_a)).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_operands_equal_fresh_ones(weights, dtype):
    _, port = weights
    audio = torch.from_numpy(_inputs(2, 4, 4, seed=4)[1])
    ops = fusion.fusion_operands(port, audio, dtype)
    again = fusion.fusion_operands(port, audio, dtype)
    fresh = fusion._derive_weights(dict(port.named_parameters()), dtype)
    assert set(ops) == set(fresh) | {"wqk", "m"}
    for k, v in fresh.items():
        assert again[k] is ops[k], f"{k} was derived again"
        assert ops[k].dtype == dtype and ops[k].is_contiguous()
        assert torch.equal(ops[k], v), k


@pytest.mark.parametrize("how", ["in_place_step", "load_state_dict"])
def test_operand_cache_follows_a_weight_update(how):
    """The output follows new weights (against the JAX kernel in interpret
    mode on those weights) after an in-place update of a chain weight, as an
    optimizer step makes, or a load_state_dict."""
    params = _jax_fusion_params(C, seed=0)
    port = _slice_from(params)
    fea_v, fea_a = _inputs(2, 7, 9, seed=5)
    before = _port_out(port, fea_v, fea_a)
    if how == "in_place_step":
        fc1 = port.cross_att.blocks[0].mlp.fc1.weight
        delta = np.random.RandomState(6).uniform(-0.05, 0.05, fc1.shape).astype(np.float32)
        with torch.no_grad():
            fc1.add_(torch.from_numpy(delta))
        mlp = params["cross_att"]["block0"]["mlp"]["fc1"]
        mlp["kernel"] = mlp["kernel"] + delta.T
    else:
        params = _jax_fusion_params(C, seed=8)
        port.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    got = _port_out(port, fea_v, fea_a)
    np.testing.assert_allclose(got, _jax_ref(params, fea_v, fea_a), **TOL)
    assert np.abs(got - before).max() > 1e-3


def test_operand_cache_keeps_two_models_apart(weights):
    params, port = weights
    params_b = _jax_fusion_params(C, seed=9)
    port_b = _slice_from(params_b)
    fea_v, fea_a = _inputs(2, 8, 8, seed=10)
    got_a = _port_out(port, fea_v, fea_a)
    got_b = _port_out(port_b, fea_v, fea_a)
    np.testing.assert_allclose(got_b, _jax_ref(params_b, fea_v, fea_a), **TOL)
    np.testing.assert_array_equal(_port_out(port, fea_v, fea_a), got_a)
    np.testing.assert_allclose(got_a, _jax_ref(params, fea_v, fea_a), **TOL)


# ---- the bf16 chain's tile plan and its contract with the source ------------

# (B, N): ragged (no multiple of the tile), B = 1, the serving bucket, a
# ragged train-sized batch, the train shape and the eval batch
WALKS = [(3, 63), (1, 3136), (8, 3136), (3, 3199), (32, 3136), (120, 3136)]


@pytest.mark.parametrize("B,N", WALKS)
def test_tile_walk_covers_every_token_once(B, N):
    sms, T = 132, fusion.TILE_TOKENS
    walk = fusion.tile_walk(B, N, sms)
    tiles = -(-N // T)
    assert len(walk) == min(B * tiles, sms)
    counts = [len(mine) for mine in walk]
    assert max(counts) - min(counts) <= 1  # the persistent grid is balanced
    seen = np.zeros((B, N), np.int64)
    for block, mine in enumerate(walk):
        for i, (b, first, valid) in enumerate(mine):
            t = block + i * len(walk)  # image-major order, strided by the grid
            assert (b, first) == (t // tiles, (t % tiles) * T)
            assert 0 < valid <= T and (valid == T or first + valid == N)
            seen[b, first:first + valid] += 1
    assert (seen == 1).all()
    if N % T:
        assert walk and all(v == N % T for mine in walk for _, f, v in mine if f + T > N)


def _chain_source():
    return (Path(fusion.__file__).parents[2] / "csrc" / "fusion_chain_sm90.cuh").read_text()


def test_wrapper_checks_follow_the_chain_source():
    """The wrapper's tile and shape constants against the bf16 chain's
    source (which only the card compiles), and its refusals before any
    launch."""
    src = _chain_source()
    const = lambda name: int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))
    assert const("kRows") == fusion.TILE_TOKENS
    assert const("kWideRows") == fusion.WIDE_TILE_TOKENS
    assert tuple(const(k) for k in ("kWideC", "kNarrowC", "kHRNetC", "kOCRC")) == \
        fusion.CHAIN_WIDTHS
    assert const("kHidden") == fusion.CHAIN_HIDDEN
    assert const("kHeads") == fusion.CHAIN_HEADS
    body = re.search(r"inline bool supported\(int C, int hidden, int mlp_hidden, int heads\) "
                     r"\{(.*?)\}", src, re.S).group(1)
    assert all(k in body for k in ("kWideC", "kNarrowC", "kHRNetC", "kOCRC"))
    assert "mlp_hidden % C == 0" in body
    # each width has its launch: the 304 design's two, the wide chain's two
    launch = re.search(r"template <bool kTrain> int launch\(const Args& a, int C, "
                       r"cudaStream_t stream\) \{(.*?)\n\}", src, re.S).group(1)
    assert "launch_width<kTrain, kWideC>" in launch and "launch_width<kTrain, kNarrowC>" in launch
    assert "wide::launch<kTrain, kHRNetC>" in launch and "wide::launch<kTrain, kOCRC>" in launch
    assert fusion.chain_supported(304, 256, 1216, 4) and fusion.chain_supported(112, 256, 448, 4)
    assert fusion.chain_supported(720, 256, 2880, 4) and fusion.chain_supported(512, 256, 2048, 4)
    for shape in ((320, 256, 1280, 4), (304, 128, 1216, 4), (304, 256, 1200, 4),
                  (304, 256, 1216, 8), (304, 256, 0, 4), (720, 256, 2000, 4),
                  (640, 256, 2560, 4)):
        assert not fusion.chain_supported(*shape), shape
    # the eval kernel's bf16 path goes through the chain and nothing else
    k1 = (Path(fusion.__file__).parents[2] / "csrc" / "fusion_kernel.cu").read_text()
    assert '#include "fusion_chain_sm90.cuh"' in k1 and "chain::launch<false>" in k1
    assert "chain::supported(C, hidden, mlp_hidden, heads)" in k1
    assert "wmma" not in k1 and "namespace tc" not in k1
    # a shape the chain does not take is refused before the library loads
    ops = {"w1": torch.zeros(320, 256, dtype=torch.bfloat16),
           "wm1": torch.zeros(320, 1280, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="bf16 kernel takes"):
        fusion._launch(torch.zeros(1, 8, 320, dtype=torch.bfloat16), ops, 4)


def test_chain_arguments_follow_the_wrappers_operands():
    """The chain's argument record against the eval wrapper's operand order
    (the C function maps them in that order) and the train wrapper's."""
    src = re.sub(r"//[^\n]*", "", _chain_source())
    body = re.search(r"struct Args \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\*?(\w+)\s*[,;]", body)
    weights = fields[3:fields.index("y")]
    assert fields[:3] == ["x", "wqk", "m"]
    assert weights == list(ft.WEIGHT_NAMES)
    k1 = re.sub(r"\s+", " ", (Path(fusion.__file__).parents[2] / "csrc"
                               / "fusion_kernel.cu").read_text())
    init = re.search(r"const chain::Args a\{(.*?)\};", k1).group(1)
    names = [re.sub(r"\(const T\*\)|\(T\*\)", "", v).strip() for v in init.split(",")]
    eval_order = ["x", "wqk", "m", "w1", "b1", "w2f", "b2f", "nullptr", "nullptr", "n1s", "n1b",
                  "bp", "n2s", "n2b", "wm1", "bm1", "wm2", "bm2", "n3s", "n3b", "out", "B", "N",
                  "mlp_hidden", "scale"]
    assert names == eval_order
