"""Bilinear upsample + argmax over classes as one CUDA kernel, and its plain
PyTorch version.

Replaces the TPU kernel ``cavp_tpu/ops/pallas/upsample_argmax_kernel.py``
(``upsample_argmax``): the eval step upsamples the class logits to the
input resolution only to reduce them over the class axis, so the kernel
writes the int32 mask and the full-resolution logits never reach device
memory. The kernel is ``csrc/upsample_argmax_kernel.cu``; its source note
gives the bound on the H100 (bytes) and the design.

The kernel's W pass walks column groups (:func:`column_groups`): runs of
neighbouring output columns that share their two source columns, so a
thread loads each source class vector once for the whole run.

The contract is bitwise: for bf16 the mask equals
``argmax(interpolate_bilinear_separable(logits))``, which is what the JAX
kernel and the JAX module path give (H pass, round to the IO dtype, W pass,
round; interpolation weights rounded to the IO dtype; first maximum on
ties). The kernel sums the two taps of ``axis_taps`` where the plain version
multiplies by the interpolation matrix: the same numbers for bf16. For
float32 a matrix product may fuse a multiply-add, so there equality holds
away from near-ties.

:func:`upsample_argmax` takes the plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from cavp_tpu_torch.ops.interp import axis_taps, interpolate_bilinear_separable

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# a block's H-pass tile, [tile_rows, w, Cp] in the IO dtype (Cp: C padded
# to a multiple of _VEC): at most this much, so that two blocks share an SM;
# never more than a block can have
_TILE_BYTES = 96 * 1024
_MAX_SMEM = 227 * 1024
_VEC = 8       # classes a vector in csrc/upsample_argmax_kernel.cu (kVec)
_GROUP = 4     # output columns of a column group, at most (kGroup)


def upsample_argmax_reference(logits: torch.Tensor, out_hw: Tuple[int, int],
                              align_corners: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample_argmax`, on any device."""
    up = interpolate_bilinear_separable(logits, out_hw, align_corners)
    return up.argmax(-1).to(torch.int32)


def column_groups(w: int, W: int, align_corners: bool = False) -> torch.Tensor:
    """The W pass's work items: int32 [n, 4] rows (first output column,
    columns, lo, hi), each a run of at most 4 neighbouring output columns
    whose two source columns (``axis_taps``) are the same, covering every
    output column once, in order."""
    lo, hi, _, _ = axis_taps(w, W, align_corners, torch.float32)
    groups = []
    for X in range(W):
        pair = (int(lo[X]), int(hi[X]))
        if groups and groups[-1][2:] == list(pair) and groups[-1][1] < _GROUP:
            groups[-1][1] += 1
        else:
            groups.append([X, 1, *pair])
    return torch.tensor(groups, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _device_taps(h: int, w: int, H: int, W: int, align_corners: bool,
                 dtype: torch.dtype, device: torch.device):
    """int32 [2H]: rows (lo, hi); float32 [2H + 2W]: their weights, then the
    columns' (w_lo, w_hi); int32 [n, 4]: the column groups."""
    r_lo, r_hi, r_wl, r_wh = axis_taps(h, H, align_corners, dtype)
    _, _, c_wl, c_wh = axis_taps(w, W, align_corners, dtype)
    idx = torch.cat([r_lo, r_hi]).to(torch.int32)
    wts = torch.cat([r_wl, r_wh, c_wl, c_wh]).to(torch.float32)
    groups = column_groups(w, W, align_corners)
    return (idx.to(device).contiguous(), wts.to(device).contiguous(),
            groups.to(device).contiguous())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with the C signatures declared."""
    from cavp_tpu_torch.ops._build import load_library

    lib = load_library()
    fn = lib.cavp_upsample_argmax
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cavp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cavp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def tile_rows(w: int, C: int, dtype: torch.dtype = torch.float32) -> int:
    """Output rows per block: the most of 8, 4, 2, 1 whose H-pass tile
    stays within the shared-memory budget."""
    row_bytes = w * -(-C // _VEC) * _VEC * torch.finfo(dtype).bits // 8
    for rows in (8, 4, 2, 1):
        if rows * row_bytes <= _TILE_BYTES:
            return rows
    if row_bytes <= _MAX_SMEM:
        return 1
    raise ValueError(f"one row of {w} x {C} logits does not fit in shared memory")


@torch.no_grad()
def upsample_argmax(logits: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """argmax over classes of the bilinear resize of ``logits`` to
    ``out_hw``. logits: [B, h, w, C] (channels last), float32 or bfloat16.
    Returns int32 [B, H, W].

    CPU tensors take :func:`upsample_argmax_reference`; CUDA tensors launch
    the kernel (counted in ``upsample_argmax.launches``) or raise.
    """
    if logits.dim() != 4:
        raise ValueError(f"need logits [B, h, w, C], got {tuple(logits.shape)}")
    if logits.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {logits.dtype}")
    H, W = (int(v) for v in out_hw)
    if logits.device.type == "cpu":
        return upsample_argmax_reference(logits, (H, W), align_corners)
    if logits.device.type != "cuda":
        raise ValueError(f"no upsample + argmax kernel for device {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous in [B, h, w, C]")
    B, h, w, C = logits.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid's 65535")
    rows = tile_rows(w, C, logits.dtype)
    lib = _library()
    taps_i, taps_f, groups = _device_taps(h, w, H, W, bool(align_corners), logits.dtype,
                                          logits.device)
    out = torch.empty(B, H, W, dtype=torch.int32, device=logits.device)
    err = lib.cavp_upsample_argmax(
        _DTYPE_CODE[logits.dtype], logits.data_ptr(), taps_i.data_ptr(),
        taps_f.data_ptr(), groups.data_ptr(), groups.shape[0], out.data_ptr(),
        B, h, w, C, H, W, rows, torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        msg = lib.cavp_cuda_error_string(err).decode()
        raise RuntimeError(f"upsample + argmax kernel launch failed: {msg} ({err})")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0
