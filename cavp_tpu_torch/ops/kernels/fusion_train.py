"""The train fusion stage as a forward and a backward CUDA kernel, and
their plain PyTorch versions.

Replaces the TPU kernels of ``cavp_tpu/ops/pallas/fusion_train_kernel.py``
(``fusion_train``; bodies ``_fwd_kernel`` and ``_bwd_kernel``). The train
step runs the fusion chain at dup=2: one visual batch B against the
matched and the shuffled audio features. Per visual token::

    t1 = gelu(x @ W1 + b1)            projector fc1, GELU in float32
    t2 = t1 @ W2 + b2                 projector fc2 (not folded here)
    a  = LN1(t2 @ Wpe + bpe)          patch_embed_v, shared norm1
    for each half d (matched, shuffled):
        g  = sigmoid((a @ wqk[d]) * hd^-1/2)       rank-1 gate
        t4 = a + (g @ m[d] + bp)
        t5 = t4 + (gelu(LN2(t4) @ Wm1 + bm1) @ Wm2 + bm2)
        y[d] = LN3(t5)

The backward recomputes the chain from the forward's inputs and emits
``dx``, the per-image ``dwqk``/``dm`` and all 17 weight, bias and
LayerNorm-affine gradients accumulated in float32, so none of autograd's
intermediates of the fusion stage (the float [2B, N, 4C] GELU input above
all) reaches device memory. The bf16 forward is the token chain of
``csrc/fusion_chain_sm90.cuh``, shared with the eval kernel (tiles of
:data:`~cavp_tpu_torch.ops.kernels.fusion.TILE_TOKENS` tokens, the shapes of
:func:`~cavp_tpu_torch.ops.kernels.fusion.chain_supported`). The bf16
backward is three launches: stage A
recomputes the chain per tile of 32 tokens and writes dx, the bias and
LayerNorm-affine gradients' per-block partial sets and the bf16 operands
of the weight-gradient products; stage B contracts those operands over
long token ranges (:data:`SPLIT_TOKENS`); a reduction sums every partial
set in a fixed order. float32 (the parity checks) is one fused launch and
the reduction. The kernels are ``csrc/fusion_train_kernel.cu``; its source
note gives the bound on the H100 and the design.

As in the TPU wrapper (``fusion_train_kernel.py:391-408``) the per-image
audio side runs in plain, differentiable torch here: ``patch_embed_a``,
norm1 on the 2B audio tokens, k and v, the rank-1 folds ``wqk`` and ``m``
and their regroup to ``[B, 2, ...]``. Autograd carries the kernel's
``dwqk``/``dm`` into it and into the float32 master parameters.

:func:`token_chain_train` and :func:`token_chain_train_backward` take
their plain versions (:func:`token_chain_train_reference`,
:func:`token_chain_train_backward_reference`, transcriptions of the TPU
kernel bodies with their rounding points) only for tensors on the CPU.
For a CUDA tensor they launch the kernels or raise.
:func:`token_chain_train_backward_two_stage` is the plain version of the
bf16 backward's three launches, the weight gradients summed in their
order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Mapping, Sequence, Tuple, Union

import torch
import torch.nn as nn

from cavp_tpu_torch.models.attn import rank1_factors
from cavp_tpu_torch.ops.kernels.fusion import (
    CHAIN_HEADS, CHAIN_HIDDEN, CHAIN_WIDTHS, _state, chain_supported)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
WEIGHT_NAMES = ("w1", "b1", "w2", "b2", "wpe", "bpe", "g1", "c1", "bp",
                "g2", "c2", "wm1", "bm1", "wm2", "bm2", "g3", "c3")
_SQRT_2PI_INV = 0.3989422804014327
_INV_SQRT2 = 0.7071067811865476


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _gelu_f32(x):
    return x * (0.5 * (1.0 + torch.erf(x * _INV_SQRT2)))


def _dgelu_f32(x):
    """gelu'(x) = Phi(x) + x * pdf(x)."""
    return (0.5 * (1.0 + torch.erf(x * _INV_SQRT2))
            + x * _SQRT_2PI_INV * torch.exp(-0.5 * x * x))


def _ln_fwd(x, g, c, eps=1e-5):
    """LayerNorm in float32: (y in x's dtype, xhat f32, r f32)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mu) * r
    return (xhat * g.float() + c.float()).to(x.dtype), xhat, r


def _ln_bwd(dy, xhat, r, g):
    """dx (f32) of LayerNorm; the caller handles dg and dc."""
    dyf = dy.float() * g.float()
    m1 = dyf.mean(-1, keepdim=True)
    m2 = (dyf * xhat).mean(-1, keepdim=True)
    return r * (dyf - m1 - xhat * m2)


def _mm(x, w):
    """x @ w with float32 accumulation, float32 result."""
    return x.float() @ w.float()


def _mm_t(dy, w):
    return dy.float() @ w.float().t()


def _outer(x, dy):
    """x^T @ dy over every token, float32."""
    return x.float().reshape(-1, x.shape[-1]).t() @ dy.float().reshape(-1, dy.shape[-1])


def _sum_tokens(v):
    return v.float().reshape(-1, v.shape[-1]).sum(0)


def token_chain_train_reference(x: torch.Tensor, wqk2: torch.Tensor, m2: torch.Tensor,
                                ws: Sequence[torch.Tensor], num_heads: int = 4
                                ) -> torch.Tensor:
    """Plain forward with ``_fwd_kernel``'s rounding points.

    x [B, N, C]; wqk2 [B, 2, C, heads]; m2 [B, 2, heads, C]; ``ws`` the 17
    operands of :data:`WEIGHT_NAMES` (matrices [in, out], vectors 1-D),
    all in x's dtype. Returns y [2B, N, C]: the matched half, then the
    shuffled one."""
    (w1, b1, w2, b2, wpe, bpe, g1, c1, bp, g2, c2, wm1, bm1, wm2, bm2, g3, c3) = ws
    dt = x.dtype
    scale = (x.shape[-1] // num_heads) ** -0.5
    t1 = _gelu_f32(_mm(x, w1) + b1.float()).to(dt)
    t2 = _mm(t1, w2).to(dt) + b2
    t3 = _mm(t2, wpe).to(dt) + bpe
    a, _, _ = _ln_fwd(t3, g1, c1)
    ys = []
    for d in (0, 1):
        s = torch.einsum("bnc,bch->bnh", a.float(), wqk2[:, d].float())
        gate = torch.sigmoid(s * scale).to(dt)
        o = torch.einsum("bnh,bhc->bnc", gate.float(), m2[:, d].float()).to(dt) + bp
        t4 = a + o
        b4, _, _ = _ln_fwd(t4, g2, c2)
        h1 = _gelu_f32(_mm(b4, wm1) + bm1.float()).to(dt)
        t5 = t4 + (_mm(h1, wm2).to(dt) + bm2)
        ys.append(_ln_fwd(t5, g3, c3)[0])
    return torch.cat(ys, dim=0)


# the weight-gradient products dW = X^T dY: (weight, X, dY). The 2-D
# operands are [tokens, width]; b4, dh0, h1 and dt5 hold both halves
# ([2 * B * N, width]), so wm1 and wm2 contract over both at once.
PRODUCTS = (("w1", "x", "dt0"), ("w2", "t1", "dt2"), ("wpe", "t2", "dt3"),
            ("wm1", "b4", "dh0"), ("wm2", "h1", "dt5"))
# the bias and LayerNorm-affine gradients: column sums of float cotangents
VECTORS = ("b1", "b2", "bpe", "g1", "c1", "bp", "g2", "c2", "bm1", "bm2", "g3", "c3")
# tokens per split of stage B's contraction (a fixed number, so that the
# sums' order does not depend on the card)
SPLIT_TOKENS = 12544


def _backward_parts(x, wqk2, m2, ws, dy, num_heads):
    """``_bwd_kernel``'s recompute and hand-derived VJP with its rounding
    points, up to the weight-matrix gradients: (dx, dwqk2 f32, dm2 f32,
    {vector name: f32 gradient}, {operand name: 2-D operand of a
    weight-gradient product, in x's dtype})."""
    (w1, b1, w2, b2, wpe, bpe, g1, c1, bp, g2, c2, wm1, bm1, wm2, bm2, g3, c3) = ws
    dt = x.dtype
    B, C = x.shape[0], x.shape[-1]
    scale = (C // num_heads) ** -0.5
    dy = dy.to(dt)
    vec = {k: torch.zeros(dict(zip(WEIGHT_NAMES, ws))[k].shape, dtype=torch.float32,
                          device=x.device) for k in VECTORS}
    dwqk2 = torch.zeros(wqk2.shape, dtype=torch.float32, device=x.device)
    dm2 = torch.zeros(m2.shape, dtype=torch.float32, device=x.device)
    halves = {k: [] for k in ("b4", "dh0", "h1", "dt5")}
    flat = lambda v: v.reshape(-1, v.shape[-1])

    # recompute the shared prefix
    t0 = _mm(x, w1) + b1.float()
    t1 = _gelu_f32(t0).to(dt)
    t2 = _mm(t1, w2).to(dt) + b2
    t3 = _mm(t2, wpe).to(dt) + bpe
    a, ahat, r1 = _ln_fwd(t3, g1, c1)

    da = torch.zeros(a.shape, dtype=torch.float32, device=x.device)
    for d in (0, 1):
        wqk, m = wqk2[:, d], m2[:, d]
        # recompute this half
        s = torch.einsum("bnc,bch->bnh", a.float(), wqk.float())
        gate_f = torch.sigmoid(s * scale)
        gate = gate_f.to(dt)
        o = torch.einsum("bnh,bhc->bnc", gate.float(), m.float()).to(dt) + bp
        t4 = a + o
        b4, b4hat, r2 = _ln_fwd(t4, g2, c2)
        h0 = _mm(b4, wm1) + bm1.float()
        h1 = _gelu_f32(h0).to(dt)
        t5 = t4 + (_mm(h1, wm2).to(dt) + bm2)
        _, t5hat, r3 = _ln_fwd(t5, g3, c3)

        # backward through this half
        dyd = dy[d * B:(d + 1) * B]
        dyf = dyd.float()
        vec["g3"] += _sum_tokens(dyf * t5hat)
        vec["c3"] += _sum_tokens(dyf)
        dt5 = _ln_bwd(dyd, t5hat, r3, g3)
        dt5d = dt5.to(dt)
        dh1 = _mm_t(dt5d, wm2)
        vec["bm2"] += _sum_tokens(dt5)
        dh0 = dh1 * _dgelu_f32(h0)
        dh0d = dh0.to(dt)
        db4 = _mm_t(dh0d, wm1)
        vec["bm1"] += _sum_tokens(dh0)
        vec["g2"] += _sum_tokens(db4 * b4hat)
        vec["c2"] += _sum_tokens(db4)
        dt4 = dt5 + _ln_bwd(db4.to(dt), b4hat, r2, g2)
        dt4d = dt4.to(dt)
        dgate = torch.einsum("bnc,bhc->bnh", dt4d.float(), m.float())
        dm2[:, d] += torch.einsum("bnh,bnc->bhc", gate.float(), dt4d.float())
        vec["bp"] += _sum_tokens(dt4)
        ds = (dgate * gate_f * (1.0 - gate_f) * scale).to(dt)
        dwqk2[:, d] += torch.einsum("bnc,bnh->bch", a.float(), ds.float())
        da += dt4 + torch.einsum("bnh,bch->bnc", ds.float(), wqk.float())
        for k, v in (("b4", b4), ("dh0", dh0d), ("h1", h1), ("dt5", dt5d)):
            halves[k].append(flat(v))

    # the shared prefix, backward
    dad = da.to(dt)
    vec["g1"] += _sum_tokens(da * ahat)
    vec["c1"] += _sum_tokens(da)
    dt3 = _ln_bwd(dad, ahat, r1, g1)
    dt3d = dt3.to(dt)
    dt2 = _mm_t(dt3d, wpe)
    vec["bpe"] += _sum_tokens(dt3)
    dt2d = dt2.to(dt)
    dt1 = _mm_t(dt2d, w2)
    vec["b2"] += _sum_tokens(dt2)
    dt0 = dt1 * _dgelu_f32(t0)
    dt0d = dt0.to(dt)
    dx = _mm_t(dt0d, w1).to(dt)
    vec["b1"] += _sum_tokens(dt0)
    operands = dict(x=flat(x), t1=flat(t1), t2=flat(t2), dt3=flat(dt3d), dt2=flat(dt2d),
                    dt0=flat(dt0d), **{k: torch.cat(v) for k, v in halves.items()})
    return dx, dwqk2, dm2, vec, operands


def token_chain_train_backward_reference(
        x: torch.Tensor, wqk2: torch.Tensor, m2: torch.Tensor,
        ws: Sequence[torch.Tensor], dy: torch.Tensor, num_heads: int = 4
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Plain backward: ``_bwd_kernel``'s recompute and hand-derived VJP
    with its rounding points, without autograd.

    ``dy`` [2B, N, C] is the cotangent of the forward's result. Returns
    (dx [B, N, C] in x's dtype, dwqk2 f32, dm2 f32, the 17 weight
    gradients in float32 in :data:`WEIGHT_NAMES` order)."""
    dx, dwqk2, dm2, grads, ops = _backward_parts(x, wqk2, m2, ws, dy, num_heads)
    for name, a, b in PRODUCTS:
        grads[name] = _outer(ops[a], ops[b])
    return dx, dwqk2, dm2, [grads[k] for k in WEIGHT_NAMES]


def token_chain_train_backward_two_stage(
        x: torch.Tensor, wqk2: torch.Tensor, m2: torch.Tensor,
        ws: Sequence[torch.Tensor], dy: torch.Tensor, num_heads: int = 4,
        split_tokens: int = SPLIT_TOKENS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """The plain version of the bf16 backward's three launches: stage A's
    operands and vector gradients (:func:`_backward_parts`), then each
    weight gradient as stage B's float partials over ``split_tokens``
    tokens at a time, summed in split order as the reduction does. The same
    function as :func:`token_chain_train_backward_reference`; only the
    order of the weight gradients' float sums differs."""
    dx, dwqk2, dm2, grads, ops = _backward_parts(x, wqk2, m2, ws, dy, num_heads)
    for name, a, b in PRODUCTS:
        parts = [_outer(xa, xb) for xa, xb in zip(torch.split(ops[a], split_tokens),
                                                   torch.split(ops[b], split_tokens))]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        grads[name] = total
    return dx, dwqk2, dm2, [grads[k] for k in WEIGHT_NAMES]


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with the C signatures declared."""
    from cavp_tpu_torch.ops._build import load_library

    lib = load_library()
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cavp_fusion_train_fwd.argtypes = [i, vp, vp, vp, vp, vp] + [i] * 6 + [f, vp]
    lib.cavp_fusion_train_fwd.restype = i
    lib.cavp_fusion_train_bwd_f32.argtypes = [vp] * 9 + [i] * 7 + [f, vp]
    lib.cavp_fusion_train_bwd_f32.restype = i
    lib.cavp_fusion_train_bwd_a.argtypes = [vp] * 11 + [i] * 7 + [f, vp]
    lib.cavp_fusion_train_bwd_a.restype = i
    lib.cavp_fusion_train_bwd_b.argtypes = [vp, i, vp]
    lib.cavp_fusion_train_bwd_b.restype = i
    lib.cavp_fusion_train_reduce.argtypes = [vp, i, vp]
    lib.cavp_fusion_train_reduce.restype = i
    lib.cavp_cuda_error_string.argtypes = [i]
    lib.cavp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cavp_cuda_error_string(err).decode()
        raise RuntimeError(f"fusion train kernel: {what} failed: {msg} ({err})")


def _validate(x, wqk2, m2, ws, num_heads):
    if x.dim() != 3:
        raise ValueError(f"need tokens [B, N, C], got {tuple(x.shape)}")
    B, N, C = x.shape
    if C % num_heads:
        raise ValueError(f"C={C} is not divisible by {num_heads} heads")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if tuple(wqk2.shape) != (B, 2, C, num_heads) or tuple(m2.shape) != (B, 2, num_heads, C):
        raise ValueError(f"need wqk2 [B,2,C,heads] and m2 [B,2,heads,C], got "
                         f"{tuple(wqk2.shape)} and {tuple(m2.shape)}")
    if len(ws) != len(WEIGHT_NAMES):
        raise ValueError(f"need the {len(WEIGHT_NAMES)} operands {WEIGHT_NAMES}")
    hidden, mlp_hidden = ws[1].shape[0], ws[12].shape[0]  # the biases' lengths
    shapes = dict(w1=(C, hidden), b1=(hidden,), w2=(hidden, C), wpe=(C, C),
                  wm1=(C, mlp_hidden), bm1=(mlp_hidden,), wm2=(mlp_hidden, C))
    for k, w in zip(WEIGHT_NAMES, ws):
        if tuple(w.shape) != shapes.get(k, (C,)):
            raise ValueError(f"operand {k} has shape {tuple(w.shape)}, "
                             f"expected {shapes.get(k, (C,))}")
    return B, N, C, hidden, mlp_hidden


def _validate_cuda(x, named, hidden, mlp_hidden):
    if x.device.type != "cuda":
        raise ValueError(f"no fusion train kernel for device {x.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel grid's 65535")
    # float32 runs on the CUDA cores (float4 rows); bf16 on the tensor cores
    # in steps of 16 (the forward also needs chain_supported's shapes)
    step = 16 if x.dtype == torch.bfloat16 else 4
    C = x.shape[-1]
    if C % step or hidden % step or mlp_hidden % step:
        raise ValueError(f"the {x.dtype} kernels need C, hidden and mlp_hidden "
                         f"to be multiples of {step}, got {C}, {hidden}, {mlp_hidden}")
    for k, v in named:
        if v.device != x.device or v.dtype != x.dtype or not v.is_contiguous():
            raise ValueError(f"operand {k} must be a contiguous {x.dtype} "
                             f"tensor on {x.device}")


def _pointer_array(ws):
    return (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))


def token_chain_train(x: torch.Tensor, wqk2: torch.Tensor, m2: torch.Tensor,
                      ws: Sequence[torch.Tensor], num_heads: int = 4) -> torch.Tensor:
    """The forward token chain, y [2B, N, C]: the plain version for CPU
    tensors; for CUDA tensors the forward kernel (counted in
    ``token_chain_train.launches``) or an error. No autograd here:
    :func:`fusion_train` wraps both directions."""
    B, N, C, hidden, mlp_hidden = _validate(x, wqk2, m2, ws, num_heads)
    if x.device.type == "cpu":
        return token_chain_train_reference(x, wqk2, m2, ws, num_heads)
    _validate_cuda(x, [("x", x), ("wqk2", wqk2), ("m2", m2), *zip(WEIGHT_NAMES, ws)],
                   hidden, mlp_hidden)
    if x.dtype == torch.bfloat16 and not chain_supported(C, hidden, mlp_hidden, num_heads):
        raise ValueError(f"the bf16 forward takes C in {CHAIN_WIDTHS}, hidden {CHAIN_HIDDEN}, "
                         f"mlp_hidden a multiple of C and {CHAIN_HEADS} heads, got "
                         f"{C}, {hidden}, {mlp_hidden}, {num_heads}")
    lib = _library()
    y = torch.empty((2 * B, N, C), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.cavp_fusion_train_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), wqk2.data_ptr(), m2.data_ptr(),
        _pointer_array(ws), y.data_ptr(), B, N, C, hidden, mlp_hidden, num_heads,
        (C // num_heads) ** -0.5, stream)
    _check(lib, err, "the forward launch")
    token_chain_train.launches += 1
    return y


token_chain_train.launches = 0


class _Product(ctypes.Structure):
    """``Product`` of the kernel source: one weight gradient of stage B."""
    _fields_ = [("X", ctypes.c_void_p), ("D", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("M", ctypes.c_int), ("N", ctypes.c_int),
                ("tokens", ctypes.c_longlong), ("split", ctypes.c_longlong)]


class _Segment(ctypes.Structure):
    """``Segment`` of the kernel source: out[g * n + e] = sum over
    p < nparts of part[g * gstride + p * pstride + e]."""
    _fields_ = [("part", ctypes.c_void_p), ("out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("pstride", ctypes.c_longlong), ("gstride", ctypes.c_longlong),
                ("nparts", ctypes.c_int), ("groups", ctypes.c_int)]


def _segments(rows):
    """A ctypes array of :class:`_Segment` from (part, out, n, nparts,
    pstride, groups, gstride) rows; ``part`` and ``out`` float tensors."""
    return (_Segment * len(rows))(*(
        _Segment(part.data_ptr(), out.data_ptr(), n, pstride, gstride, nparts, groups)
        for part, out, n, nparts, pstride, groups, gstride in rows))


# the bf16 backward's operands of stage B, in the order of the kernel's
# ``Operands``, with their widths and whether they hold both halves
_OPERANDS = (("t1", "hid", 1), ("t2", "C", 1), ("dt3", "C", 1), ("dt2", "C", 1),
             ("dt0", "hid", 1), ("b4", "C", 2), ("h1", "mh", 2), ("dt5", "C", 2),
             ("dh0", "mh", 2))
_TILE_TOKENS = 32  # stage A's token tile (TA in the source)


class _BackwardPlan:
    """One bf16 backward on the card as its three launches, with every
    buffer allocated up front: :meth:`stage_a`, :meth:`stage_b`,
    :meth:`reduce`, then :meth:`result`. Each launch counts itself in
    ``token_chain_train_backward.launches`` where it is made. Stage A's
    operands stay readable in ``operands`` (2-D, [tokens, width])."""

    def __init__(self, x, wqk2, m2, ws, dy, num_heads):
        B, N, C = x.shape
        hid, mh = ws[1].shape[0], ws[12].shape[0]
        if mh + 8 < 2 * C:
            raise ValueError(f"the bf16 backward keeps dt4 in float in the MLP hidden's "
                             f"buffer: needs mlp_hidden >= 2C - 8, got {mh} for C={C}")
        self.lib, dev, f32 = _library(), x.device, torch.float32
        self.args = (x, wqk2, m2, ws, dy, num_heads)
        self.dims = (B, N, C, hid, mh)
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        self.per_image = max(1, min(-(-N // _TILE_TOKENS), sms // B))
        nblk = B * self.per_image
        width = dict(C=C, hid=hid, mh=mh)
        self.operands = {"x": x.reshape(B * N, C)}
        for name, w, halves in _OPERANDS:
            self.operands[name] = torch.empty((halves * B * N, width[w]), dtype=x.dtype,
                                              device=dev)
        self.vec_sizes = [dict(zip(WEIGHT_NAMES, ws))[k].numel() for k in VECTORS]
        self.vec_part = torch.zeros((nblk, sum(self.vec_sizes)), dtype=f32, device=dev)
        self.dwqk_part = torch.zeros((B, self.per_image, 2 * C * num_heads), dtype=f32,
                                     device=dev)
        self.dm_part = torch.zeros((B, self.per_image, 2 * num_heads * C), dtype=f32,
                                   device=dev)
        self.da_scratch = torch.empty((nblk, _TILE_TOKENS, C), dtype=f32, device=dev)
        self.dx = torch.empty_like(x)
        # stage B: the largest products first, so the last wave is short
        self.parts = {}
        for name, a, b in sorted(PRODUCTS, key=lambda p: -self.operands[p[1]].numel()):
            tokens, M = self.operands[a].shape
            splits = -(-tokens // SPLIT_TOKENS)
            self.parts[name] = torch.empty((splits, M, self.operands[b].shape[1]), dtype=f32,
                                           device=dev)
        self.products = (_Product * len(PRODUCTS))(*(
            _Product(self.operands[a].data_ptr(), self.operands[b].data_ptr(),
                     self.parts[name].data_ptr(), self.operands[a].shape[1],
                     self.operands[b].shape[1], self.operands[a].shape[0], SPLIT_TOKENS)
            for name, a, b in sorted(PRODUCTS, key=lambda p: -self.operands[p[1]].numel())))
        # the reduction: every weight gradient into one flat buffer
        sizes = [w.numel() for w in ws]
        self.dw = torch.empty(sum(sizes), dtype=f32, device=dev)
        out = dict(zip(WEIGHT_NAMES, torch.split(self.dw, sizes)))
        self.dws = [out[k].view(w.shape) for k, w in zip(WEIGHT_NAMES, ws)]
        self.dwqk2 = torch.empty(wqk2.shape, dtype=f32, device=dev)
        self.dm2 = torch.empty(m2.shape, dtype=f32, device=dev)
        rows = [(p, out[k], p[0].numel(), p.shape[0], p[0].numel(), 1, 0)
                for k, p in self.parts.items()]
        vparts = torch.split(self.vec_part, self.vec_sizes, dim=1)
        rows += [(v, out[k], n, nblk, self.vec_part.shape[1], 1, 0)
                 for k, v, n in zip(VECTORS, vparts, self.vec_sizes)]
        for part, res in ((self.dwqk_part, self.dwqk2), (self.dm_part, self.dm2)):
            n = part.shape[2]
            rows.append((part, res, n, self.per_image, n, B, self.per_image * n))
        self.segments = _segments(rows)

    def stage_a(self):
        x, wqk2, m2, ws, dy, num_heads = self.args
        B, N, C, hid, mh = self.dims
        ops = (ctypes.c_void_p * len(_OPERANDS))(
            *(self.operands[name].data_ptr() for name, _, _ in _OPERANDS))
        err = self.lib.cavp_fusion_train_bwd_a(
            x.data_ptr(), wqk2.data_ptr(), m2.data_ptr(), _pointer_array(ws), dy.data_ptr(),
            self.dx.data_ptr(), ops, self.vec_part.data_ptr(), self.dwqk_part.data_ptr(),
            self.dm_part.data_ptr(), self.da_scratch.data_ptr(), self.per_image, B, N, C, hid,
            mh, num_heads, (C // num_heads) ** -0.5, self.stream)
        _check(self.lib, err, "the backward's stage A launch")
        token_chain_train_backward.launches["stage_a"] += 1

    def stage_b(self):
        err = self.lib.cavp_fusion_train_bwd_b(self.products, len(self.products), self.stream)
        _check(self.lib, err, "the backward's stage B launch")
        token_chain_train_backward.launches["stage_b"] += 1

    def reduce(self):
        err = self.lib.cavp_fusion_train_reduce(self.segments, len(self.segments), self.stream)
        _check(self.lib, err, "the reduction of the partial gradients")
        token_chain_train_backward.launches["reduce"] += 1

    def result(self):
        return self.dx, self.dwqk2, self.dm2, self.dws


def _backward_f32(x, wqk2, m2, ws, dy, num_heads):
    """The float32 backward on the card: one fused launch (tiles of 16
    tokens, per-block partial sets), then the reduction."""
    B, N, C = x.shape
    hid, mh = ws[1].shape[0], ws[12].shape[0]
    lib, dev, f32 = _library(), x.device, torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_image = max(1, min(-(-N // 16), sms // B))
    sizes = [w.numel() for w in ws]
    total = sum(sizes)
    dw_part = torch.zeros((B * per_image, total), dtype=f32, device=dev)
    dwqk_part = torch.zeros((B, per_image, 2 * C * num_heads), dtype=f32, device=dev)
    dm_part = torch.zeros((B, per_image, 2 * num_heads * C), dtype=f32, device=dev)
    dx = torch.empty_like(x)
    dw = torch.empty(total, dtype=f32, device=dev)
    dwqk2 = torch.empty(wqk2.shape, dtype=f32, device=dev)
    dm2 = torch.empty(m2.shape, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cavp_fusion_train_bwd_f32(
        x.data_ptr(), wqk2.data_ptr(), m2.data_ptr(), _pointer_array(ws), dy.data_ptr(),
        dx.data_ptr(), dwqk_part.data_ptr(), dm_part.data_ptr(), dw_part.data_ptr(),
        per_image, B, N, C, hid, mh, num_heads, (C // num_heads) ** -0.5, stream)
    _check(lib, err, "the float32 backward launch")
    token_chain_train_backward.launches["f32"] += 1
    rows = [(dw_part, dw, total, B * per_image, total, 1, 0)]
    for part, out in ((dwqk_part, dwqk2), (dm_part, dm2)):
        n = part.shape[2]
        rows.append((part, out, n, per_image, n, B, per_image * n))
    segs = _segments(rows)
    err = lib.cavp_fusion_train_reduce(segs, len(segs), stream)
    _check(lib, err, "the reduction of the partial gradients")
    token_chain_train_backward.launches["reduce"] += 1
    dws = [g.reshape(w.shape) for g, w in zip(torch.split(dw, sizes), ws)]
    return dx, dwqk2, dm2, dws


def token_chain_train_backward(
        x: torch.Tensor, wqk2: torch.Tensor, m2: torch.Tensor,
        ws: Sequence[torch.Tensor], dy: torch.Tensor, num_heads: int = 4
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """The backward token chain: (dx, dwqk2 f32, dm2 f32, 17 float32
    weight gradients). The plain version for CPU tensors; for CUDA
    tensors the kernels or an error.

    bf16 takes three launches (:class:`_BackwardPlan`): stage A recomputes
    the chain per tile of 32 tokens and writes dx, the vector gradients'
    per-block partial sets and the bf16 operands of the weight-gradient
    products; stage B contracts those over token ranges of
    :data:`SPLIT_TOKENS` into float partials; the reduction sums every
    partial set in a fixed order, so the result does not depend on how the
    blocks were scheduled. float32 takes one fused launch and the
    reduction. ``token_chain_train_backward.launches`` counts each kind of
    launch (``stage_a``, ``stage_b``, ``reduce``, ``f32``)."""
    B, N, C, hidden, mlp_hidden = _validate(x, wqk2, m2, ws, num_heads)
    if tuple(dy.shape) != (2 * B, N, C):
        raise ValueError(f"need dy [2B, N, C], got {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return token_chain_train_backward_reference(x, wqk2, m2, ws, dy, num_heads)
    dy = dy.to(x.dtype).contiguous()
    _validate_cuda(x, [("x", x), ("wqk2", wqk2), ("m2", m2), ("dy", dy),
                       *zip(WEIGHT_NAMES, ws)], hidden, mlp_hidden)
    if x.dtype == torch.float32:
        return _backward_f32(x, wqk2, m2, ws, dy, num_heads)
    plan = _BackwardPlan(x, wqk2, m2, ws, dy, num_heads)
    plan.stage_a()
    plan.stage_b()
    plan.reduce()
    return plan.result()


token_chain_train_backward.launches = dict.fromkeys(("stage_a", "stage_b", "reduce", "f32"), 0)


class _TokenChain(torch.autograd.Function):
    """The two kernels as one differentiable function. The forward saves
    only its inputs; the backward recomputes."""

    @staticmethod
    def forward(ctx, num_heads, x, wqk2, m2, *ws):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, wqk2, m2, *ws)
        return token_chain_train(x, wqk2, m2, ws, num_heads)

    @staticmethod
    def backward(ctx, dy):
        x, wqk2, m2, *ws = ctx.saved_tensors
        dx, dwqk2, dm2, dws = token_chain_train_backward(
            x, wqk2, m2, ws, dy, ctx.num_heads)
        return (None, dx, dwqk2.to(wqk2.dtype), dm2.to(m2.dtype),
                *(g.to(w.dtype) for g, w in zip(dws, ws)))


def train_operands(model_or_params: Union[nn.Module, Mapping[str, torch.Tensor]],
                   fea_a: torch.Tensor, batch: int, dtype: torch.dtype,
                   num_heads: int = 4
                   ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """The token chain's operands in ``dtype``, differentiable: the
    per-image rank-1 factors regrouped into dup pairs, ``wqk2``
    [B, 2, C, heads] and ``m2`` [B, 2, heads, C], from the audio features
    ``fea_a`` [2B, C] (matched, then shuffled), and the 17 weights of
    :data:`WEIGHT_NAMES` with matrices laid out [in, out]."""
    p = _state(model_or_params)
    pv, ca, blk = "visual_projector", "cross_att", "cross_att.blocks.0"
    C = fea_a.shape[-1]
    mat = lambda k: p[k].to(dtype).t().contiguous()
    vec = lambda k: p[k].to(dtype)

    fa = fea_a.reshape(2 * batch, C).to(dtype)
    fa = fa @ p[f"{ca}.patch_embed_a.proj.weight"].to(dtype).t() \
        + vec(f"{ca}.patch_embed_a.proj.bias")
    g1, c1 = p[f"{blk}.norm1.weight"], p[f"{blk}.norm1.bias"]
    faf = fa.float()
    mu = faf.mean(-1, keepdim=True)
    var = (faf - mu).square().mean(-1, keepdim=True)
    fan = (((faf - mu) * torch.rsqrt(var + 1e-5)) * g1.float() + c1.float()).to(dtype)
    wqk, m = rank1_factors(p[f"{blk}.attn.q.weight"], p[f"{blk}.attn.proj.weight"],
                           fan @ p[f"{blk}.attn.k.weight"].to(dtype).t(),
                           fan @ p[f"{blk}.attn.v.weight"].to(dtype).t(), num_heads)
    # [2B, ...] (matched, then shuffled) -> per-image dup pairs
    wqk2 = wqk.reshape(2, batch, C, num_heads).transpose(0, 1).contiguous()
    m2 = m.reshape(2, batch, num_heads, C).transpose(0, 1).contiguous()
    ws = [mat(f"{pv}.fc1.weight"), vec(f"{pv}.fc1.bias"),
          mat(f"{pv}.fc2.weight"), vec(f"{pv}.fc2.bias"),
          mat(f"{ca}.patch_embed_v.proj.weight"), vec(f"{ca}.patch_embed_v.proj.bias"),
          vec(f"{blk}.norm1.weight"), vec(f"{blk}.norm1.bias"),
          vec(f"{blk}.attn.proj.bias"),
          vec(f"{blk}.norm2.weight"), vec(f"{blk}.norm2.bias"),
          mat(f"{blk}.mlp.fc1.weight"), vec(f"{blk}.mlp.fc1.bias"),
          mat(f"{blk}.mlp.fc2.weight"), vec(f"{blk}.mlp.fc2.bias"),
          vec(f"{ca}.norm.weight"), vec(f"{ca}.norm.bias")]
    return wqk2, m2, ws


def fusion_train(model_or_params, fea_v_tokens: torch.Tensor, fea_a: torch.Tensor,
                 num_heads: int = 4) -> torch.Tensor:
    """The train fusion stage, differentiable in the visual tokens, the
    audio features and every parameter it reads.

    model_or_params: a ``CAVP`` module, or its named parameters
    (reference names). fea_v_tokens: [B, h*w, C] visual tokens in the IO
    dtype (float32 or bfloat16); fea_a: [2B, C] audio features, matched
    then shuffled. Returns the fused tokens [2B, h*w, C], equal up to
    rounding to ``CAVP.forward_fusion(..., dup=2)``'s.

    CPU tensors take the plain versions in both directions; CUDA tensors
    launch the kernels or raise."""
    x = fea_v_tokens
    if x.dim() != 3 or fea_a.shape[0] != 2 * x.shape[0] or fea_a.shape[-1] != x.shape[-1]:
        raise ValueError(f"need tokens [B, N, C] and audio [2B, C], got "
                         f"{tuple(x.shape)} and {tuple(fea_a.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fusion train kernel for device {x.device}")
    wqk2, m2, ws = train_operands(model_or_params, fea_a, x.shape[0], x.dtype, num_heads)
    return _TokenChain.apply(num_heads, x.contiguous(), wqk2, m2, *ws)
