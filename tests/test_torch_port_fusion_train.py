"""The port's train fusion stage against the JAX package's Pallas kernels.

``cavp_tpu_torch.ops.kernels.fusion_train`` holds the wrapper of the CUDA
forward and backward kernels and their plain PyTorch versions; on the CPU
the wrapper (a ``torch.autograd.Function``) takes the plain versions in
both directions. They are held against
``cavp_tpu.ops.pallas.fusion_train_kernel.fusion_train`` run in interpret
mode and its hand-written VJP, and against torch autograd of the port's
module path (``CAVP.forward_fusion(dup=2)``), on the same weights and
inputs made from numpy seeds, at C = 304 with a divisor (8x8) and a
ragged (7x9) token count.

The bf16 backward on the card is three launches (stage A's operands, stage
B's split-K weight gradients, a fixed-order reduction); its plain version,
``token_chain_train_backward_two_stage``, is held here against the plain
backward and against ``jax.vjp`` of the Pallas token chain, with split
boundaries inside a 32-token tile, a ragged token count and B = 1.

Tolerances (f32), as tests/test_fusion_train_kernel.py: forward rtol 1e-4
/ atol 5e-5 (the Pallas kernel's rational erf is within 1.5e-7 of exact
erf, which the MLP sums amplify to a few e-5); every gradient within
1e-4 of its largest entry (the gradients see that deviation twice,
through the recompute).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.ops.pallas import fusion_train_kernel as jax_ft
from cavp_tpu_torch.engine.convert import (
    gradients_by_name,
    named_tensors_from_jax,
    state_dict_from_jax,
)
from cavp_tpu_torch.models.cavp import map_to_tokens, tokens_to_map
from cavp_tpu_torch.ops.kernels import fusion_train as ft
from test_torch_port_fusion import FusionSlice, _jax_fusion_params
from torch_port_common import release_after_module  # noqa: F401 (autouse)

FWD_TOL = dict(rtol=1e-4, atol=5e-5)
GRAD_REL = 1e-4
C = 304
B = 2


@pytest.fixture(scope="module")
def weights():
    params = _jax_fusion_params(C, seed=0)
    port = FusionSlice(C)
    port.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    return params, port


def _inputs(hw, seed=1):
    rng = np.random.RandomState(seed)
    h, w = hw
    return (rng.randn(B, h, w, C).astype(np.float32),
            rng.randn(2 * B, C).astype(np.float32),
            rng.randn(2 * B, h * w, C).astype(np.float32))


def _operands(port, fea_a, dtype):
    """The kernels' operands as plain tensors, cut from the parameters."""
    with torch.no_grad():
        wqk2, m2, ws = ft.train_operands(port, torch.from_numpy(fea_a), B, dtype)
    return wqk2.detach(), m2.detach(), [w.detach() for w in ws]


def _assert_grads_close(got, ref, what):
    assert set(got) == set(ref)
    for k in ref:
        scale = float(ref[k].abs().max()) + 1e-12
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_forward_on_cpu_matches_jax_kernel(weights, hw):
    params, port = weights
    fea_v, fea_a, _ = _inputs(hw)
    ref = np.asarray(jax_ft.fusion_train(params, jnp.asarray(fea_v), jnp.asarray(fea_a),
                                         interpret=True))
    launches = ft.token_chain_train.launches
    tokens = torch.from_numpy(fea_v).reshape(B, hw[0] * hw[1], C)
    with torch.no_grad():
        got = ft.fusion_train(port, tokens, torch.from_numpy(fea_a))
        fused, pack = port.forward_fusion(tokens_to_map(tokens, *hw),
                                          torch.from_numpy(fea_a), dup=2)
    assert ft.token_chain_train.launches == launches == 0
    assert got.shape == ref.shape == (2 * B, hw[0] * hw[1], C)
    np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL)
    # the module path at dup=2, and its pack with the reference's 2B shapes
    np.testing.assert_allclose(map_to_tokens(fused).numpy(), ref, **FWD_TOL)
    assert pack["visual"].shape == (2 * B, C, *hw)
    assert pack["attn_v"].shape == (2 * B, 4, hw[0] * hw[1], 1)


def _port_grads(port, fn, fea_v, fea_a, wsum, hw):
    tokens = torch.from_numpy(fea_v).reshape(B, hw[0] * hw[1], C).requires_grad_()
    audio = torch.from_numpy(fea_a).requires_grad_()
    port.zero_grad(set_to_none=True)
    (fn(tokens, audio) * torch.from_numpy(wsum)).sum().backward()
    grads = gradients_by_name(port)
    grads["fea_v"], grads["fea_a"] = tokens.grad.clone(), audio.grad.clone()
    return grads


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_backward_on_cpu_matches_jax_vjp_and_module_autograd(weights, hw):
    """Every leaf: projector, patch embeds, norms, q/k/v/proj, MLP, both
    inputs; the loss weights both halves differently."""
    params, port = weights
    fea_v, fea_a, wsum = _inputs(hw, seed=2)

    def loss(p, v, a):
        return jnp.sum(jax_ft.fusion_train(p, v, a, interpret=True) * jnp.asarray(wsum))

    gp, gv, ga = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        params, jnp.asarray(fea_v), jnp.asarray(fea_a))
    ref = named_tensors_from_jax(jax.tree_util.tree_map(np.asarray, gp))
    ref["fea_v"] = torch.from_numpy(np.array(gv)).reshape(B, -1, C)
    ref["fea_a"] = torch.from_numpy(np.array(ga))

    launches = dict(ft.token_chain_train_backward.launches)
    kernel_path = _port_grads(port, lambda t, a: ft.fusion_train(port, t, a),
                              fea_v, fea_a, wsum, hw)
    assert ft.token_chain_train_backward.launches == launches
    assert not any(launches.values())
    _assert_grads_close(kernel_path, ref, "autograd.Function vs jax.grad of the Pallas path")

    module_path = _port_grads(
        port, lambda t, a: map_to_tokens(port.forward_fusion(tokens_to_map(t, *hw), a, dup=2)[0]),
        fea_v, fea_a, wsum, hw)
    _assert_grads_close(kernel_path, module_path, "autograd.Function vs the module path")
    # the positional embeddings are allocated and unused: no gradient
    for k in ("cross_att.pos_embed_v", "cross_att.pos_embed_a"):
        assert float(kernel_path[k].abs().max()) == 0.0
        assert dict(port.named_parameters())[k].grad is None


def test_plain_backward_matches_autograd_of_plain_forward(weights):
    """The transcribed VJP against autograd of the transcribed forward,
    on the operands the kernels get: dx, dwqk2, dm2 and the 17 weights."""
    _, port = weights
    fea_v, fea_a, wsum = _inputs((7, 9), seed=3)
    x = torch.from_numpy(fea_v).reshape(B, 63, C)
    wqk2, m2, ws = _operands(port, fea_a, torch.float32)
    dy = torch.from_numpy(wsum)
    dx, dwqk2, dm2, dws = ft.token_chain_train_backward(x, wqk2, m2, ws, dy)
    leaves = [t.clone().requires_grad_() for t in (x, wqk2, m2, *ws)]
    ft.token_chain_train_reference(leaves[0], leaves[1], leaves[2], leaves[3:]).backward(dy)
    names = ("dx", "dwqk2", "dm2") + ft.WEIGHT_NAMES
    for k, got, leaf in zip(names, (dx, dwqk2, dm2, *dws), leaves):
        assert got.shape == leaf.shape and got.dtype == torch.float32
        scale = float(leaf.grad.abs().max()) + 1e-12
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=k)


def test_bf16_plain_versions_track_f32(weights):
    """The bf16 rounding points of the plain versions (what the card holds
    its kernels against): the forward stays within bf16 error of f32
    (|y| reaches ~5, one ulp there is 0.03), the gradients within 5% of
    their largest entry."""
    _, port = weights
    fea_v, fea_a, wsum = _inputs((8, 8), seed=4)
    x = torch.from_numpy(fea_v).reshape(B, 64, C)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        wqk2, m2, ws = _operands(port, fea_a, dt)
        y = ft.token_chain_train(x.to(dt), wqk2, m2, ws)
        grads = ft.token_chain_train_backward(x.to(dt), wqk2, m2, ws,
                                              torch.from_numpy(wsum).to(dt))
        assert y.dtype == grads[0].dtype == dt and grads[1].dtype == torch.float32
        out[dt] = (y.float(), grads[0].float(), grads[1], grads[2], *grads[3])
    f32, bf16 = out[torch.float32], out[torch.bfloat16]
    np.testing.assert_allclose(bf16[0].numpy(), f32[0].numpy(), rtol=0, atol=0.15)
    assert float((bf16[0] - f32[0]).abs().mean()) < 0.01
    for a, b in zip(bf16[1:], f32[1:]):
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())


def test_wrapper_never_falls_back_off_the_cpu(weights):
    _, port = weights
    with pytest.raises(ValueError, match="no fusion train kernel"):
        ft.fusion_train(port, torch.empty(2, 64, C, device="meta"),
                        torch.empty(4, C, device="meta"))
    with pytest.raises(ValueError, match="audio"):
        ft.fusion_train(port, torch.zeros(2, 4, C), torch.zeros(2, C))
    wqk2, m2, ws = _operands(port, np.zeros((4, C), np.float32), torch.float32)
    with pytest.raises(ValueError, match="heads"):
        ft.token_chain_train(torch.zeros(2, 4, C), wqk2, m2, ws, num_heads=3)
    with pytest.raises(ValueError, match="dy"):
        ft.token_chain_train_backward(torch.zeros(2, 4, C), wqk2, m2, ws,
                                      torch.zeros(2, 4, C))
    with pytest.raises(ValueError, match="operand w1"):
        ft.token_chain_train(torch.zeros(2, 4, C), wqk2, m2, [ws[1]] + ws[1:])


# (B, (h, w), tokens per split): the default split (one per product); 40
# tokens, so that split boundaries fall inside stage A's 32-token tiles and
# the 2BN-token products take more splits than the others; B = 1
TWO_STAGE = {"ragged": (2, (7, 9), ft.SPLIT_TOKENS), "split_inside_tile": (2, (7, 9), 40),
             "b1": (1, (8, 8), 48)}


def _chain_inputs(port, B, hw, seed):
    rng = np.random.RandomState(seed)
    n = hw[0] * hw[1]
    x = torch.from_numpy(rng.randn(B, n, C).astype(np.float32))
    fea_a = rng.randn(2 * B, C).astype(np.float32)
    dy = torch.from_numpy(rng.randn(2 * B, n, C).astype(np.float32))
    with torch.no_grad():
        wqk2, m2, ws = ft.train_operands(port, torch.from_numpy(fea_a), B, torch.float32)
    return x, wqk2.detach(), m2.detach(), [w.detach() for w in ws], dy


def _assert_flat_close(got, ref, what):
    names = ("dx", "dwqk2", "dm2") + ft.WEIGHT_NAMES
    got = [got[0], got[1], got[2], *got[3]]
    ref = [ref[0], ref[1], ref[2], *ref[3]]
    for k, a, r in zip(names, got, ref):
        a, r = torch.tensor(np.array(a)).float(), torch.tensor(np.array(r)).float()
        assert a.shape == r.reshape(a.shape).shape, (what, k)
        scale = float(r.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy(), r.reshape(a.shape).numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", sorted(TWO_STAGE))
def test_two_stage_backward_matches_plain_backward(weights, case):
    B, hw, split = TWO_STAGE[case]
    x, wqk2, m2, ws, dy = _chain_inputs(weights[1], B, hw, seed=5)
    tokens = B * hw[0] * hw[1]
    if case != "ragged":
        assert tokens % split and split % 32 and tokens > split
    got = ft.token_chain_train_backward_two_stage(x, wqk2, m2, ws, dy, split_tokens=split)
    ref = ft.token_chain_train_backward_reference(x, wqk2, m2, ws, dy)
    assert got[0].dtype == torch.float32 and all(g.dtype == torch.float32 for g in got[3])
    _assert_flat_close(got, ref, f"two-stage vs plain backward ({case})")


@pytest.mark.parametrize("case", sorted(TWO_STAGE))
def test_two_stage_backward_matches_jax_pallas_vjp(weights, case):
    """``jax.vjp`` of the JAX package's token chain, its Pallas forward and
    backward kernels in interpret mode, on the same operands."""
    B, hw, split = TWO_STAGE[case]
    x, wqk2, m2, ws, dy = _chain_inputs(weights[1], B, hw, seed=6)
    jws = [jnp.asarray(w.numpy()).reshape(1, -1) if w.dim() == 1 else jnp.asarray(w.numpy())
           for w in ws]
    _, vjp = jax.vjp(lambda *a: jax_ft._token_chain(4, True, *a), jnp.asarray(x.numpy()),
                     jnp.asarray(wqk2.numpy()), jnp.asarray(m2.numpy()), *jws)
    out = vjp((jnp.asarray(dy[:B].numpy()), jnp.asarray(dy[B:].numpy())))
    ref = (out[0], out[1], out[2], list(out[3:]))
    got = ft.token_chain_train_backward_two_stage(x, wqk2, m2, ws, dy, split_tokens=split)
    _assert_flat_close(got, ref, f"two-stage vs the Pallas VJP ({case})")


def test_backward_bindings_follow_the_kernel_source():
    """The wrapper's operand, vector and record orders against
    ``csrc/fusion_train_kernel.cu``, which only the card runs."""
    src = (Path(ft.__file__).parents[2] / "csrc" / "fusion_train_kernel.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)

    def fields(struct):
        body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
        return re.findall(r"(\w+)\s*[,;]", body)

    assert fields("Operands") == [name for name, _, _ in ft._OPERANDS]
    order = re.findall(r"o\.(\w+) = o\.\w+ \+", src)
    assert ["b1"] + order[:-1] == list(ft.VECTORS) and order[-1] == "total"
    assert fields("Product") == [f for f, _ in ft._Product._fields_]
    assert fields("Segment") == [f for f, _ in ft._Segment._fields_]
    assert "TA = %d;" % ft._TILE_TOKENS in src


def test_bf16_backward_refuses_a_narrow_mlp_before_any_launch(weights):
    """dt4 is kept in float in the MLP hidden's buffer of stage A."""
    x, wqk2, m2, ws, dy = _chain_inputs(weights[1], 1, (4, 4), seed=7)
    ws = list(ws)
    ws[11], ws[12], ws[13] = ws[11][:, :512], ws[12][:512], ws[13][:512]
    before = dict(ft.token_chain_train_backward.launches)
    with pytest.raises(ValueError, match="mlp_hidden"):
        ft._BackwardPlan(x.bfloat16(), wqk2, m2, ws, dy, 4)
    assert ft.token_chain_train_backward.launches == before


def test_bf16_forward_binding_follows_the_chain_source():
    """The bf16 forward is the chain of ``csrc/fusion_chain_sm90.cuh`` (the
    earlier WMMA body is gone), with the 17 operands handed over in the
    order of :data:`WEIGHT_NAMES`, and shapes the chain does not take are
    refused by the wrapper's check."""
    csrc = Path(ft.__file__).parents[2] / "csrc"
    src = re.sub(r"\s+", " ", (csrc / "fusion_train_kernel.cu").read_text())
    assert '#include "fusion_chain_sm90.cuh"' in src
    assert "chain::launch<true>" in src and "fwd_kernel<bf16" not in src
    assert "wmma" not in src and "Mm<bf16" not in src
    assert "chain::supported(C, hidden, mlp_hidden, heads)" in src
    init = re.search(r"const chain::Args a\{(.*?)\};", src).group(1)
    names = [re.sub(r"\((P|bf16\*)\)", "", v).strip() for v in init.split(",")]
    assert names[:3] == ["x", "wqk2", "m2"]
    assert names[3:20] == [f"w.{k}" for k in ft.WEIGHT_NAMES]
    assert names[20:] == ["y", "B", "N", "mlp_hidden", "scale"]
    # the train model's shapes (C 304, hidden 256, 4C, 4 heads) and the
    # ResNet-18 one's (C 112) are taken; a narrower MLP is not
    assert ft.chain_supported(C, 256, 4 * C, 4) and ft.chain_supported(112, 256, 448, 4)
    assert not ft.chain_supported(C, 256, 512, 4)
