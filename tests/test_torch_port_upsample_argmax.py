"""The port's upsample + argmax (K4) against the JAX package.

On the CPU the port's wrapper takes its plain version: the separable
bilinear resize with the kernel's rounding points (weights rounded to the
IO dtype, H pass, round, W pass, round), each pass a matrix product as in
the JAX package, and a first-maximum argmax. The CUDA kernel sums the two
taps of ``axis_taps`` instead, which a test here shows to be the same
numbers for bf16. Here the plain version is held against the
JAX Pallas kernel in interpret mode:

- bf16: bit-equal masks. Every product of two bf16 values is exact in
  float32, so the float32 sums of the matrix products and the two-tap
  sum round once, identically; ties (planted) go to the first class in
  both;
- float32: the JAX matrix product may fuse a multiply-add, so masks are
  equal wherever the top two resized logits differ by more than 1e-5;
- ``interpolate_bilinear_separable`` against the JAX module path's
  ``interpolate_bilinear``: bit-equal for bf16, 1e-6 for float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cavp_tpu.ops.interp import (
    _interp_matrix as jax_interp_matrix,
    interpolate_bilinear as jax_interpolate_bilinear,
)
from cavp_tpu.ops.pallas.upsample_argmax_kernel import upsample_argmax as jax_upsample_argmax
from cavp_tpu_torch.ops.interp import axis_taps, interp_matrix, interpolate_bilinear_separable
from cavp_tpu_torch.ops.kernels.upsample_argmax import (
    column_groups,
    tile_rows,
    upsample_argmax,
    upsample_argmax_reference,
)
from torch_port_common import release_after_module  # noqa: F401 (autouse)


def _logits(seed, shape, ties=True):
    """bf16-representable float32 logits with exact ties planted: class
    pairs made equal over whole regions, and a constant patch."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16().float()
    if ties:
        B, h, w, C = shape
        x[:, : h // 2, :, C - 1] = x[:, : h // 2, :, 0]      # first wins over last
        x[:, :, : w // 3, 1] = x[:, :, : w // 3, 2]
        x[0, h // 2:, w // 2:, :] = 0.25                       # everything ties: class 0
    return x


def _jax(x, dtype):
    return jnp.asarray(x.numpy()).astype(dtype)


BF16_CASES = [((2, 14, 14, 71), (56, 56), False),    # the head's class count, 4x
              ((2, 10, 12, 5), (33, 47), False),     # a non-integer ratio
              ((1, 7, 9, 130), (16, 40), False),     # more classes than a lane tile
              ((2, 8, 8, 6), (32, 32), True)]


@pytest.mark.parametrize("shape,out_hw,align", BF16_CASES)
def test_bf16_masks_are_bit_equal_to_the_jax_kernel(shape, out_hw, align):
    x = _logits(sum(shape), shape)
    ref = np.asarray(jax_upsample_argmax(_jax(x, jnp.bfloat16), out_hw,
                                         align_corners=align, interpret=True))
    got = upsample_argmax(x.bfloat16(), out_hw, align_corners=align)
    assert got.dtype == torch.int32 and tuple(got.shape) == (shape[0],) + out_hw
    np.testing.assert_array_equal(got.numpy(), ref)
    # the planted ties were decided, and for the first class
    assert (got[0, -1, -1] == 0) and len(np.unique(ref)) > 2
    # and equal to the argmax of the JAX module path's resize
    up = jax_interpolate_bilinear(_jax(x, jnp.bfloat16), out_hw, align_corners=align)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(up, -1)))


@pytest.mark.parametrize("shape,out_hw", [((2, 14, 14, 71), (56, 56)),
                                          ((2, 10, 12, 5), (33, 47))])
def test_float32_masks_equal_the_jax_kernel_away_from_near_ties(shape, out_hw):
    x = torch.from_numpy(np.random.RandomState(3).randn(*shape).astype(np.float32))
    ref = np.asarray(jax_upsample_argmax(jnp.asarray(x.numpy()), out_hw, interpret=True))
    got = upsample_argmax(x, out_hw).numpy()
    top2 = interpolate_bilinear_separable(x, out_hw).topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > 1e-5).numpy()
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], ref[clear])


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 0.0), (torch.float32, 1e-6)])
@pytest.mark.parametrize("align", [False, True])
def test_separable_resize_matches_the_jax_module_path(dtype, atol, align):
    x = _logits(5, (2, 9, 11, 7), ties=False).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_interpolate_bilinear(_jax(x.float(), jdt), (30, 23), align_corners=align)
    got = interpolate_bilinear_separable(x, (30, 23), align_corners=align)
    assert got.dtype == dtype and tuple(got.shape) == (2, 30, 23, 7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("shape,out_hw,align", BF16_CASES)
def test_bf16_separable_resize_is_the_two_tap_sum_bit_for_bit(shape, out_hw, align):
    """What the CUDA kernel computes per pass: lo * w_lo + hi * w_hi with
    float32 products and one float32 add, rounded to bf16."""
    x = _logits(sum(shape) + 1, shape).bfloat16()
    want = x
    for axis, size in ((1, out_hw[0]), (2, out_hw[1])):
        lo, hi, w_lo, w_hi = axis_taps(want.shape[axis], size, align, torch.bfloat16)
        view = [1, 1, 1, 1]
        view[axis] = -1
        want = (want.index_select(axis, lo).float() * w_lo.view(view)
                + want.index_select(axis, hi).float() * w_hi.view(view)).bfloat16()
    assert torch.equal(interpolate_bilinear_separable(x, out_hw, align), want)


def test_separable_resize_is_close_to_torch_bilinear():
    """One rounding per pass against F.interpolate's single one: equal to
    float32 rounding."""
    x = _logits(6, (2, 14, 14, 5), ties=False)
    ref = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(56, 56),
                                          mode="bilinear", align_corners=False)
    got = interpolate_bilinear_separable(x, (56, 56))
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sizes", [(14, 56, False), (56, 224, False), (10, 33, False),
                                   (8, 32, True), (5, 5, False)])
def test_interp_matrix_and_taps_match_jax(sizes):
    n_in, n_out, align = sizes
    m = interp_matrix(n_in, n_out, align)
    np.testing.assert_array_equal(m, jax_interp_matrix(n_in, n_out, align))
    for dtype in (torch.float32, torch.bfloat16):
        lo, hi, w_lo, w_hi = axis_taps(n_in, n_out, align, dtype)
        dense = torch.zeros(n_out, n_in)
        dense[torch.arange(n_out), lo] += w_lo
        dense[torch.arange(n_out), hi] += w_hi
        assert torch.equal(dense, torch.from_numpy(m).to(dtype).float())


def test_wrapper_checks_its_input_and_never_falls_back():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="B, h, w, C"):
        upsample_argmax(x[0], (8, 8))
    with pytest.raises(ValueError, match="dtype"):
        upsample_argmax(x.half(), (8, 8))
    before = upsample_argmax.launches
    with pytest.raises(ValueError, match="no upsample"):
        upsample_argmax(x.to("meta"), (8, 8))
    assert torch.equal(upsample_argmax(x, (8, 8)), upsample_argmax_reference(x, (8, 8)))
    assert upsample_argmax.launches == before
    # the eval shape: 4 output rows of [56, 71] floats a block; a wide map: 1
    assert tile_rows(56, 71) == 4 and tile_rows(128, 71) == 2 and tile_rows(512, 71) == 1
    with pytest.raises(ValueError, match="shared memory"):
        tile_rows(1024, 71)


@pytest.mark.parametrize("sizes", [(56, 224, False), (14, 56, False), (10, 33, False),
                                   (8, 32, True), (5, 5, False), (3, 40, False), (40, 131, True)])
def test_column_groups_cover_every_column_once_with_its_taps(sizes):
    """The W pass's work items: runs of at most 4 output columns, in order,
    covering each column once; every column of a run reads only the run's
    two source columns, which are the nonzero entries of its row of the
    JAX package's interpolation matrix (both, where they differ)."""
    n_in, n_out, align = sizes
    m = jax_interp_matrix(n_in, n_out, align)
    groups = column_groups(n_in, n_out, align)
    assert groups.dtype == torch.int32 and groups.shape[1] == 4
    nxt = 0
    for first, count, lo, hi in groups.tolist():
        assert first == nxt and 1 <= count <= 4 and 0 <= lo <= hi < n_in
        for X in range(first, first + count):
            nonzero = set(np.flatnonzero(m[X]).tolist())
            assert nonzero <= {lo, hi} and (lo in nonzero or hi in nonzero)
        nxt = first + count
    assert nxt == n_out
    if (n_in, n_out) == (56, 224):  # 4x: four columns share a pair, the edges two more
        assert groups[:, 1].tolist() == [4, 2] + [4] * 54 + [2]
