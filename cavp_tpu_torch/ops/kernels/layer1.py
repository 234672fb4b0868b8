"""ResNet layer1 at eval as fused CUDA bottleneck kernels, and the plain
PyTorch version.

Replaces the TPU kernel ``cavp_tpu/ops/pallas/layer1_kernel.py``
(``fused_layer1``): every bottleneck of the stage (1x1, 3x3, 1x1, eval
BatchNorm folded into a per-channel affine, the downsample branch of block
0, residual, ReLU) with the intermediate activations kept on chip. The
kernel is ``csrc/layer1_kernel.cu``, one launch per bottleneck; its source
note gives the bound on the H100 (operations) and the design: tiles of rows
and columns of one image with a one-pixel halo, the bf16 products on wgmma
with the 3x3 as an implicit GEMM (the machinery of ``csrc/sm90.cuh``).

The rounding points are the TPU kernel's, not the module path's: the
folded affine is applied to the float32 sums, then ReLU, then one rounding
to the IO dtype; BN3's output and the downsample branch are each rounded
before the add; the 3x3's padding is zero after the affine.
:func:`fused_layer1_reference` transcribes exactly that. Against the
module chain (which rounds the conv output before the affine) the result
agrees to rounding, not bitwise.

:func:`fused_layer1` takes the plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernels or raises: nothing gives way to
the module path. Maps of any size go to the kernel: :func:`tile_plan`
picks each bottleneck's tiles (:func:`tile_walk` lists them as the kernel
takes them). The folded affines and the weights' casts and layouts are
derived once per parameter version (:func:`layer1_operands`).
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PLANES = 64          # the kernel's bottleneck width
# mirrors of csrc/layer1_kernel.cu (l1::geometry, l1::smem_bytes): a
# position's 64 bf16 channels, the weight ring, the 64-row chunks a product
# runs in (at most four a tile), and a block's shared memory
_ROW_BYTES = 128
_RING_BYTES = 6 * 8192 + 8 * (2 * 6 + 2) + 1024
_MAX_CHUNKS = 4
_MAX_SMEM = 232448


class TilePlan(NamedTuple):
    """Output tiles of ``rows`` x ``cols`` pixels, ``pitch`` halo'd
    positions a tile row (a multiple of 8, at least ``cols + 2``)."""
    rows: int
    cols: int
    pitch: int


def _geometry(rows: int, pitch: int) -> Tuple[int, int, int, int]:
    """(chunks of the first 1x1, chunks of the later products, input rows
    a panel, rows of an h1 copy) of a tile, as ``l1::geometry``."""
    P = (rows + 2) * pitch
    nc1, nci = -(-P // 64), -(-(rows * pitch) // 64)
    xrows = max(64 * nc1, pitch + 64 * nci)
    hrows = -(-max(64 * nci + 2 * pitch, P + 1) // 8) * 8
    return nc1, nci, xrows, hrows


def _smem_bytes(cin: int, rows: int, pitch: int) -> int:
    """A bf16 block's shared memory (``l1::smem_bytes``): cin / 64 input
    panels, three h1 copies, the ring."""
    _, _, xrows, hrows = _geometry(rows, pitch)
    return _ROW_BYTES * ((cin // _PLANES) * xrows + 3 * hrows) + _RING_BYTES


@functools.lru_cache(maxsize=None)
def tile_plan(H: int, W: int, cin: int, cout: int, first: bool) -> TilePlan:
    """The bottleneck's tiles on an H x W map: of every pitch and band
    height that fits (at most four 64-row chunks a product, a block's shared
    memory), the one with the fewest tensor-core operations, halo included,
    then the fewest tiles. Bands and column tiles are balanced, so a ragged
    edge is spread over them."""
    per_row = 9 * _PLANES * _PLANES + _PLANES * cout + (cin * cout if first else 0)
    best = None
    for pitch in range(8, 257, 8):
        tiles_x = -(-W // (pitch - 2))
        cols = -(-W // tiles_x)
        for band in range(1, min(H, 254) + 1):
            tiles_y = -(-H // band)
            rows = -(-H // tiles_y)
            nc1, nci, _, _ = _geometry(rows, pitch)
            if nc1 > _MAX_CHUNKS:
                break
            if nci > _MAX_CHUNKS or _smem_bytes(cin, rows, pitch) > _MAX_SMEM:
                continue
            tiles = tiles_x * tiles_y
            cost = tiles * 64 * (nc1 * cin * _PLANES + nci * per_row)
            key = (cost, tiles, -pitch)
            if best is None or key < best[0]:
                best = (key, TilePlan(rows, cols, pitch))
    if best is None:
        raise ValueError(f"no layer1 tile fits {cin} input channels in shared memory")
    return best[1]


def tile_walk(H: int, W: int, plan: TilePlan) -> List[Tuple[int, int, int, int]]:
    """The tiles of one image as the kernel takes them (``tile_of``):
    (first row, first column, valid rows, valid columns), band by band."""
    return [(r0, c0, min(plan.rows, H - r0), min(plan.cols, W - c0))
            for r0 in range(0, H, plan.rows) for c0 in range(0, W, plan.cols)]


def _fold_bn(bn: nn.BatchNorm2d, eps: float):
    """gamma / sqrt(var + eps), beta - mean * that, float32 [C]."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    return s.contiguous(), (bn.bias.float() - bn.running_mean.float() * s).contiguous()


def _block_tensors(blk: nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors one bottleneck's operands are derived from, by name."""
    mods = {"conv1": blk.conv1, "conv2": blk.conv2, "conv3": blk.conv3,
            "bn1": blk.bn1, "bn2": blk.bn2, "bn3": blk.bn3}
    if blk.downsample is not None:
        mods.update(convd=blk.downsample[0], bnd=blk.downsample[1])
    out = {}
    for name, m in mods.items():
        names = ("weight",) if name.startswith("conv") else (
            "weight", "bias", "running_mean", "running_var")
        for k in names:
            out[f"{name}.{k}"] = getattr(m, k)
    return out


def _derive_operands(blocks, dtype: torch.dtype, eps: float) -> List[Dict[str, torch.Tensor]]:
    """Per bottleneck: the conv weights in ``dtype`` laid out [in, out]
    (w2 tap-major, [9, in, out]) and the folded BatchNorm affines in
    float32; block 0 also holds the downsample branch (wd, sd, td)."""
    out = []
    for i, blk in enumerate(blocks):
        if (blk.conv2.kernel_size != (3, 3) or blk.conv2.stride != (1, 1)
                or blk.conv2.dilation != (1, 1)):
            raise ValueError("layer1's 3x3 convs must have stride 1 and dilation 1")
        planes, cout = blk.conv1.out_channels, blk.conv3.out_channels
        ops = {
            "w1": blk.conv1.weight.to(dtype).reshape(planes, -1).t(),
            "w2": blk.conv2.weight.to(dtype).permute(2, 3, 1, 0).reshape(9, planes, planes),
            "w3": blk.conv3.weight.to(dtype).reshape(cout, planes).t(),
        }
        for k, bn in (("1", blk.bn1), ("2", blk.bn2), ("3", blk.bn3)):
            ops["s" + k], ops["t" + k] = _fold_bn(bn, eps)
        if blk.downsample is not None:
            if i != 0:
                raise ValueError("only layer1's first block may have a downsample branch")
            conv, bn = blk.downsample[0], blk.downsample[1]
            if conv.stride != (1, 1):
                raise ValueError("layer1's downsample must have stride 1")
            ops["wd"] = conv.weight.to(dtype).reshape(cout, -1).t()
            ops["sd"], ops["td"] = _fold_bn(bn, eps)
        out.append({k: v.contiguous() for k, v in ops.items()})
    return out


# layer1_operands' results, newest last: (dtype, device, eps, [(weakref,
# _version, data_ptr) of each tensor read], operands)
_OPERAND_CACHE: List[tuple] = []
_OPERAND_CACHE_SIZE = 4


@torch.no_grad()
def layer1_operands(backbone: nn.Module, dtype: torch.dtype, eps: float = 1e-5
                    ) -> List[Dict[str, torch.Tensor]]:
    """:func:`_derive_operands` of the backbone's layer1, kept while every
    conv weight and BatchNorm tensor it read is the same tensor at the same
    version (an in-place update bumps ``_version``; ``load_state_dict``
    copies in place; a new tensor fails the identity check) and at the same
    address."""
    blocks = list(backbone.layer1)
    if not blocks:
        raise ValueError("the backbone has no layer1 blocks")
    if blocks[0].downsample is None:
        raise ValueError("layer1's first block must have a downsample branch")
    tensors = [t for blk in blocks for t in _block_tensors(blk).values()]
    device = tensors[0].device
    for i, (dt, dev, ep, marks, ops) in enumerate(_OPERAND_CACHE):
        if dt == dtype and dev == device and ep == eps and len(marks) == len(tensors) and all(
                ref() is t and ver == t._version and ptr == t.data_ptr()
                for (ref, ver, ptr), t in zip(marks, tensors)):
            _OPERAND_CACHE.append(_OPERAND_CACHE.pop(i))
            return ops
    ops = _derive_operands(blocks, dtype, eps)
    marks = [(weakref.ref(t), t._version, t.data_ptr()) for t in tensors]
    _OPERAND_CACHE.append((dtype, device, eps, marks, ops))
    del _OPERAND_CACHE[:-_OPERAND_CACHE_SIZE]
    return ops


def _bottleneck_reference(x: torch.Tensor, o: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One bottleneck on [B, H, W, cin] with the kernel's rounding points."""
    dt = x.dtype
    H, W = x.shape[1:3]
    mm = lambda a, w: a.float() @ w.float()   # float32 sums of IO-dtype values
    h1 = torch.relu(mm(x, o["w1"]) * o["s1"] + o["t1"]).to(dt)
    h1 = F.pad(h1, (0, 0, 1, 1, 1, 1))        # zero after the affine
    acc = None
    for k in range(9):
        dy, dx = divmod(k, 3)
        term = mm(h1[:, dy:dy + H, dx:dx + W], o["w2"][k])
        acc = term if acc is None else acc + term
    h2 = torch.relu(acc * o["s2"] + o["t2"]).to(dt)
    out = (mm(h2, o["w3"]) * o["s3"] + o["t3"]).to(dt)
    res = (mm(x, o["wd"]) * o["sd"] + o["td"]).to(dt) if "wd" in o else x
    return torch.relu(out + res)


def _check(x: torch.Tensor, blocks) -> None:
    if x.dim() != 4:
        raise ValueError(f"need the stem output [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if x.shape[3] != blocks[0]["w1"].shape[0]:
        raise ValueError(f"the stem output has {x.shape[3]} channels, layer1 takes "
                         f"{blocks[0]['w1'].shape[0]}")


@torch.no_grad()
def fused_layer1_reference(backbone: nn.Module, x: torch.Tensor, eps: float = 1e-5
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_layer1`, on any device."""
    blocks = layer1_operands(backbone, x.dtype, eps)
    _check(x, blocks)
    for o in blocks:
        x = _bottleneck_reference(x, o)
    return x


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with the C signatures declared."""
    from cavp_tpu_torch.ops._build import load_library

    lib = load_library()
    fn = lib.cavp_layer1_bottleneck
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.cavp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cavp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch_plans(x: torch.Tensor, blocks) -> List[TilePlan]:
    """What the kernel takes, checked before anything launches: a
    contiguous, 16-byte aligned float32 or bf16 map of any size, bottlenecks
    of width 64 with channel counts that are multiples of 64, operands of the
    right dtypes on the map's device. Returns each bottleneck's tile plan."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the stem output must be contiguous in [B, H, W, C] and 16-byte aligned")
    _, H, W, _ = x.shape
    plans = []
    for o in blocks:
        cin, planes = o["w1"].shape
        cout = o["w3"].shape[1]
        if planes != _PLANES or cin % _PLANES or cout % _PLANES:
            raise ValueError(f"the kernel takes bottlenecks of width {_PLANES} with input and "
                             f"output channels multiples of {_PLANES}, got {cin} -> {planes} "
                             f"-> {cout}")
        for k, v in o.items():
            want = torch.float32 if k[0] in "st" else x.dtype
            if v.device != x.device or v.dtype != want or not v.is_contiguous():
                raise ValueError(f"operand {k} must be a contiguous {want} tensor on {x.device}")
        plans.append(tile_plan(H, W, cin, cout, "wd" in o))
    return plans


def _launch(x: torch.Tensor, blocks) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"no layer1 kernel for device {x.device}")
    plans = _launch_plans(x, blocks)
    B, H, W, _ = x.shape
    lib = _library()
    code = _DTYPE_CODE[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for o, plan in zip(blocks, plans):
        cin, cout = o["w1"].shape[0], o["w3"].shape[1]
        out = torch.empty(B, H, W, cout, dtype=x.dtype, device=x.device)
        ptr = lambda k: o[k].data_ptr() if k in o else None
        err = lib.cavp_layer1_bottleneck(
            code, x.data_ptr(), out.data_ptr(),
            ptr("w1"), ptr("s1"), ptr("t1"), ptr("w2"), ptr("s2"), ptr("t2"),
            ptr("w3"), ptr("s3"), ptr("t3"), ptr("wd"), ptr("sd"), ptr("td"),
            B, H, W, cin, cout, plan.rows, plan.cols, plan.pitch, stream)
        if err != 0:
            msg = lib.cavp_cuda_error_string(err).decode()
            raise RuntimeError(f"layer1 kernel launch failed: {msg} ({err})")
        fused_layer1.launches += 1
        x = out
    return x


@torch.no_grad()
def fused_layer1(backbone: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The whole layer1 stage at eval. backbone: the port's ``ResNet``
    (its ``layer1`` conv weights and BatchNorm buffers are read and folded
    in float32); x: [B, H, W, Cin] contiguous stem output (channels last),
    float32 or bfloat16. Returns c1 [B, H, W, 4 * planes], equal up to
    rounding to chaining the Bottleneck modules at eval. No gradient.

    CPU tensors take :func:`fused_layer1_reference`; CUDA tensors launch
    the kernel, once per bottleneck (each launch counts in
    ``fused_layer1.launches``), at any map size, or raise.
    """
    if x.device.type == "cpu":
        return fused_layer1_reference(backbone, x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no layer1 kernel for device {x.device}")
    blocks = layer1_operands(backbone, x.dtype, eps)
    _check(x, blocks)
    return _launch(x, blocks)


fused_layer1.launches = 0
