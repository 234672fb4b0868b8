"""The port's fused layer1 (K5) against the JAX package.

A JAX deep-stem ResNet's variables are drawn from a numpy seed (weights
and BatchNorm statistics off identity, as tests/test_layer1_kernel.py
jitters them) and carried into the port's ``ResNet`` with
``state_dict_from_jax``. On the CPU the port's wrapper
takes its plain version, which transcribes the kernel's rounding points
(folded BatchNorm affine on the float32 sums, ReLU, one rounding; BN3 and
the downsample branch rounded before the add; the 3x3's padding zero after
the affine). It is held against the JAX Pallas kernel in interpret mode and
against the port's own module chain:

- float32: rtol = atol = 1e-5, the JAX test's tolerance (the affine is
  applied before instead of after the conv output is rounded, and the sums
  are taken in other orders);
- bf16: within 0.02 x the largest output, the JAX test's bound; bf16
  differences come from single roundings that flip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.engine import loops as jax_loops
from cavp_tpu.models.resnet import ResNet as JaxResNet
from cavp_tpu.ops.pallas.layer1_kernel import fused_layer1 as jax_fused_layer1
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.engine import loops
from cavp_tpu_torch.engine.convert import state_dict_from_jax
from cavp_tpu_torch.engine.runner import build_model
from cavp_tpu_torch.models.resnet import ResNet
from cavp_tpu_torch.ops.kernels import layer1 as l1
from torch_port_common import model_pair, release_after_module  # noqa: F401 (autouse)
from torch_ref import randomize_bn_stats

TOL = dict(rtol=1e-5, atol=1e-5)
RSWD = (False, True, True)


def _pair(depth, seed=0, hw=(64, 64)):
    """(port ResNet, JAX module, JAX variables, image [2, H, W, 3]) on the
    same seeded weights. The variables' shapes come from ``eval_shape`` (an
    eager flax init of ResNet-50 takes 20 s); the values are drawn so that
    activations keep their scale and every folded affine is exercised:
    kernels N(0, 1 / fan_in), BatchNorm scale 1 +- 0.1, bias +- 0.1, mean
    +- 0.1, variance in [0.5, 1.5]."""
    jm = JaxResNet(depth=depth, replace_stride_with_dilation=RSWD)
    rng = np.random.RandomState(seed)
    img = rng.randn(2, *hw, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(img), False),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        return ((name == "scale") + 0.1 * rng.randn(*shape)).astype(np.float32)

    jvars = jax.tree_util.tree_map_with_path(draw, shapes)
    sd = state_dict_from_jax({"backbone": jvars["params"]},
                             {"backbone": jvars["batch_stats"]})
    prefix = "backbone.backbone."
    m = ResNet(depth, RSWD).eval()
    m.load_state_dict({k[len(prefix):]: t for k, t in sd.items()}, strict=True)
    return m, jm, jvars, img


@pytest.fixture(scope="module", params=[50, 18])
def pair(request):
    m, jm, jvars, img = _pair(request.param)
    stem = np.array(jax.jit(lambda v, x: jm.apply(v, x, False, method=JaxResNet.stem_forward))(
        jvars, jnp.asarray(img)))
    return m, jvars, img, stem


def test_stem_matches_jax_and_forward_is_the_composition(pair):
    m, jvars, img, stem = pair
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = m.stem_forward(x)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), stem, rtol=1e-4, atol=1e-4)
        feats = m.forward_from_c1(m.layer1(got))
        whole = m(x)
    assert len(feats) == len(whole) == 4
    for a, b in zip(feats, whole):
        assert torch.equal(a, b)
    assert feats[0].shape[1:] == (256, 16, 16)


def test_float32_plain_version_matches_the_jax_kernel(pair):
    m, jvars, _, stem = pair
    ref = np.asarray(jax_fused_layer1(jvars["params"], jvars["batch_stats"],
                                      jnp.asarray(stem), interpret=True))
    got = l1.fused_layer1(m, torch.from_numpy(stem))
    assert tuple(got.shape) == ref.shape == (2, 16, 16, 256)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_float32_plain_version_matches_the_module_chain(pair):
    m, _, _, stem = pair
    x = torch.from_numpy(stem)
    with torch.no_grad():
        ref = m.layer1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(l1.fused_layer1_reference(m, x).numpy(), ref.numpy(), **TOL)


def test_bf16_plain_version_within_the_jax_bound(pair):
    m, jvars, _, stem = pair
    xb = torch.from_numpy(stem).bfloat16()
    ref = np.asarray(jax_fused_layer1(
        jvars["params"], jvars["batch_stats"], jnp.asarray(stem).astype(jnp.bfloat16),
        interpret=True).astype(jnp.float32))
    got = l1.fused_layer1(m, xb)
    assert got.dtype == torch.bfloat16
    scale = max(float(np.abs(ref).max()), 1.0)
    err = np.abs(got.float().numpy() - ref)
    # measured: a few bf16 ulps at the largest entries, mean well below one
    assert err.max() < 0.02 * scale and err.mean() < 0.002 * scale
    with torch.no_grad():
        chain = m.layer1(xb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
    assert float((got.float() - chain).abs().max()) < 0.02 * max(float(chain.abs().max()), 1.0)


def test_operand_layouts_and_the_folded_affine():
    m, _, _, _ = _pair(18, seed=3, hw=(32, 32))
    blocks = l1.layer1_operands(m, torch.float32)
    assert len(blocks) == 2 and "wd" in blocks[0] and "wd" not in blocks[1]
    b0, blk = blocks[0], m.layer1[0]
    assert b0["w1"].shape == (128, 64) and b0["w2"].shape == (9, 64, 64)
    assert b0["w3"].shape == (64, 256) and b0["wd"].shape == (128, 256)
    # tap k = 3 * dy + dx holds conv2.weight[:, :, dy, dx] as [in, out]
    assert torch.equal(b0["w2"][5], blk.conv2.weight[:, :, 1, 2].t())
    x = torch.randn(4, 64, 3, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(
            (x * b0["s2"].view(1, -1, 1, 1) + b0["t2"].view(1, -1, 1, 1)).numpy(),
            blk.bn2(x).numpy(), rtol=1e-5, atol=1e-6)
    for o in blocks:
        for k, v in o.items():
            assert v.is_contiguous() and v.dtype == torch.float32, k


def test_gate_and_the_wrappers_errors():
    """The kernel takes maps of any size: the launch path's checks accept
    the 133- and 140-wide bf16 maps and the 128-wide float32 map that the
    row-tile kernel refused, and still refuse what the kernel cannot take
    (channel counts, dtype, device). The plain version on the CPU takes any
    map."""
    m = ResNet(18, RSWD).eval()
    for shape, dtype in (((1, 8, 133, 128), torch.bfloat16), ((1, 8, 140, 128), torch.bfloat16),
                         ((1, 128, 128, 128), torch.float32), ((1, 3, 1, 128), torch.float32)):
        x = torch.zeros(shape, dtype=dtype)
        plans = l1._launch_plans(x, l1.layer1_operands(m, dtype))
        assert len(plans) == 2 and all(p.cols + 2 <= p.pitch for p in plans), plans
    with pytest.raises(ValueError, match="channels"):
        l1.fused_layer1(m, torch.zeros(1, 8, 8, 64))
    narrow = [dict(o, w1=o["w1"][:, :32]) for o in l1.layer1_operands(m, torch.float32)]
    with pytest.raises(ValueError, match="width 64"):
        l1._launch_plans(torch.zeros(1, 8, 8, 128), narrow)
    with pytest.raises(ValueError, match="dtype"):
        l1.fused_layer1(m, torch.zeros(1, 8, 8, 128, dtype=torch.float16))
    with pytest.raises(ValueError, match="dtype"):
        l1._launch_plans(torch.zeros(1, 8, 8, 128, dtype=torch.float16),
                         l1.layer1_operands(m, torch.float16))
    before = l1.fused_layer1.launches
    with pytest.raises(ValueError, match="no layer1 kernel"):
        l1.fused_layer1(m, torch.zeros(1, 8, 8, 128, device="meta"))
    with pytest.raises(ValueError, match="no layer1 kernel"):
        l1._launch(torch.zeros(1, 8, 140, 128, dtype=torch.bfloat16),
                   l1.layer1_operands(m, torch.bfloat16))
    l1.fused_layer1(m, torch.zeros(1, 8, 8, 128))  # the CPU takes the plain version
    assert l1.fused_layer1.launches == before


@pytest.mark.parametrize("W", [1, 15, 16, 56, 133, 257])
def test_tile_plan_covers_every_pixel_once_with_its_halo_in_the_box(W):
    """Each bottleneck's plan (block 0: 128 -> 256 with the downsample;
    later blocks 256 -> 256) at maps 7 and 56 rows high: the tiles of
    ``tile_walk`` cover every output pixel once; the halo'd box (rows + 2
    by pitch positions) holds each tile's one-pixel halo; the chunks and
    shared memory stay within the kernel's limits (``l1::geometry``)."""
    for H in (7, 56):
        for cin, first in ((128, True), (256, False)):
            plan = l1.tile_plan(H, W, cin, 256, first)
            assert plan.pitch % 8 == 0 and plan.cols + 2 <= plan.pitch <= 256
            nc1, nci, _, _ = l1._geometry(plan.rows, plan.pitch)
            assert nc1 <= l1._MAX_CHUNKS and nci <= l1._MAX_CHUNKS
            assert l1._smem_bytes(cin, plan.rows, plan.pitch) <= l1._MAX_SMEM
            seen = np.zeros((H, W), np.int64)
            for r0, c0, rows, cols in l1.tile_walk(H, W, plan):
                assert 0 < rows <= plan.rows and 0 < cols <= plan.cols
                seen[r0:r0 + rows, c0:c0 + cols] += 1
                # box rows r0 - 1 .. r0 + plan.rows, columns c0 - 1 .. c0 - 2 + pitch
                assert r0 - 1 + plan.rows + 2 >= r0 + rows + 1
                assert c0 - 1 + plan.pitch >= c0 + cols + 1
            assert (seen == 1).all()
            tiles = -(-H // plan.rows) * -(-W // plan.cols)
            assert len(l1.tile_walk(H, W, plan)) == tiles


def _port_resnet(seed):
    """A port ResNet-18 with seeded weights and BatchNorm statistics off
    identity (no JAX side: the cache tests hold the wrapper against the
    port's own module chain)."""
    torch.manual_seed(seed)
    m = ResNet(18, RSWD).eval()
    randomize_bn_stats(m, seed)
    return m


@pytest.fixture(scope="module")
def cache_model():
    return _port_resnet(5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_operands_equal_fresh_ones(cache_model, dtype):
    ops = l1.layer1_operands(cache_model, dtype)
    again = l1.layer1_operands(cache_model, dtype)
    fresh = l1._derive_operands(list(cache_model.layer1), dtype, 1e-5)
    assert len(ops) == len(fresh) == len(again)
    for o, a, f in zip(ops, again, fresh):
        assert set(o) == set(f)
        for k in f:
            assert a[k] is o[k], f"{k} was derived again"
            assert o[k].is_contiguous() and torch.equal(o[k], f[k]), k


@pytest.mark.parametrize("how", ["in_place_step", "load_state_dict"])
def test_operand_cache_follows_a_weight_update(how):
    """After an in-place update of a conv weight (as an optimizer step
    makes) or of a BatchNorm statistic, or a load_state_dict, the wrapper's
    output is the plain version on the new weights, not the cached one."""
    m = _port_resnet(6)
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 4, 5, 128).astype(np.float32))
    before = l1.fused_layer1(m, x)
    if how == "in_place_step":
        with torch.no_grad():
            m.layer1[1].conv2.weight.mul_(1.5)
            m.layer1[0].bn3.running_var.add_(0.5)
    else:
        m.load_state_dict(_port_resnet(8).state_dict())
    got = l1.fused_layer1(m, x)
    with torch.no_grad():
        want = m.layer1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert float((got - before).abs().max()) > 1e-3


def test_operand_cache_keeps_two_models_apart(cache_model):
    other = _port_resnet(9)
    x = torch.from_numpy(np.random.RandomState(10).randn(1, 4, 5, 128).astype(np.float32))
    a, b = l1.fused_layer1(cache_model, x), l1.fused_layer1(other, x)
    with torch.no_grad():
        for m, got in ((cache_model, a), (other, b)):
            want = m.layer1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert torch.equal(l1.fused_layer1(cache_model, x), a)


def test_visual_feature_fn_routes_layer1_at_every_map_size(monkeypatch):
    """With the flag on every image size goes through the kernel wrapper,
    64x64 images (a 16x16 map) as 100x100 (25x25) and 65x65 (the stem
    rounds up: 17x17), and agrees with the module path to 1e-4 (relative and
    absolute); nothing gives way to the module path."""
    cfg = get_config("avss").replace(image_width=64, image_height=64, num_classes=5,
                                     visual_backbone=18, compute_dtype="float32",
                                     use_pallas_layer1=True)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    randomize_bn_stats(model, 1)
    calls = []
    real = loops.fused_layer1
    monkeypatch.setattr(loops, "fused_layer1",
                        lambda bkb, x: calls.append(tuple(x.shape)) or real(bkb, x))
    fea_v = loops._make_visual_feature_fn(model, cfg)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for n, size, hw in ((2, 64, 16), (1, 100, 25), (1, 65, 17)):
            image = torch.from_numpy(rng.randn(n, 3, size, size).astype(np.float32))
            want = model.forward_visual_feature(image)
            np.testing.assert_allclose(fea_v(image).numpy(), want.numpy(),
                                       rtol=1e-4, atol=1e-4)
            assert calls[-1] == (n, hw, hw, 128)
    assert len(calls) == 3
    off = loops._make_visual_feature_fn(model, cfg.replace(use_pallas_layer1=False))
    assert off == model.forward_visual_feature


def test_visual_feature_fn_matches_jax_on_a_map_wider_than_132(monkeypatch):
    """A 16 x 560 image (a 4 x 140 map, wider than the earlier row-tile
    kernel took) with the flag on: the port sends layer1 to its kernel
    wrapper, the JAX package's eval-step visual feature falls back to its
    modules (its kernel takes maps up to 56 wide); both agree to 1e-4
    (relative and absolute), as in the routing test above."""
    model, cfg, jmodel, jcfg, jvars = model_pair(seed=2, use_pallas_layer1=True)
    image = np.random.RandomState(3).randn(1, 16, 560, 3).astype(np.float32)
    calls = []
    real = loops.fused_layer1
    monkeypatch.setattr(loops, "fused_layer1",
                        lambda bkb, x: calls.append(tuple(x.shape)) or real(bkb, x))
    with torch.no_grad():
        got = loops._make_visual_feature_fn(model, cfg)(
            torch.from_numpy(image).permute(0, 3, 1, 2))
    assert calls == [(1, 4, 140, 128)]
    fea_v = jax.jit(jax_loops._make_visual_feature_fn(jmodel, jcfg))
    ref = np.asarray(fea_v(jvars, jnp.asarray(image)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)
