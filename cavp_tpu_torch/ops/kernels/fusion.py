"""The eval fusion stage as one CUDA kernel, and its plain PyTorch version.

Replaces the TPU kernel ``cavp_tpu/ops/pallas/fusion_kernel.py``
(``fused_visual_fusion``): projector -> patch embeds -> depth-1 sigmoid
cross-attention block (rank-1 collapsed) -> final norm, over the B*h*w
visual tokens. The kernel is ``csrc/fusion_kernel.cu``; its source note
gives the bound on the H100 (compute: ~1.8 MFLOP per token against
~1.2 KB of bf16 token IO) and what the design does about it.

As in the TPU wrapper (``fusion_kernel.py:147-178``), the per-image audio
side and the weight folds run in plain torch here: ``patch_embed_a``,
norm1, k and v of the single audio token, the rank-1 factors ``wqk``
[B, C, heads] and ``m`` [B, heads, C], and the fc2 @ ``patch_embed_v``
fold, done in float32. The fold and the weights' casts and transposes
depend on the parameters alone, so :func:`fusion_operands` derives them
once per model, dtype and parameter version and keeps them; only the
audio side runs on every call. The token chain then rounds to the IO
dtype at the same points as ``_fusion_kernel``, in the kernel and in
:func:`token_chain_reference` alike.

The bf16 kernel is the token chain of ``csrc/fusion_chain_sm90.cuh``
(shared with the train kernel's forward): :data:`TILE_TOKENS` tokens a
tile on a persistent grid (:func:`tile_walk`), and the shapes of
:func:`chain_supported`.

:func:`fused_visual_fusion` takes the plain version only for tensors on
the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, Mapping, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.attn import rank1_factors

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CHAIN = ("w1", "b1", "w2f", "b2f", "bp", "wm1", "bm1", "wm2", "bm2",
          "n1s", "n1b", "n2s", "n2b", "n3s", "n3b")


class _Parameters(Mapping):
    """A module's parameters by reference name, each looked up when read
    (``get_parameter``), not collected: a whole CAVP has hundreds, and the
    fusion stage reads about 25 of them on every call."""

    def __init__(self, module: nn.Module):
        self._module = module

    def __getitem__(self, name: str) -> torch.Tensor:
        try:
            return self._module.get_parameter(name)
        except AttributeError as e:
            raise KeyError(name) from e

    def __iter__(self):
        return (name for name, _ in self._module.named_parameters())

    def __len__(self):
        return sum(1 for _ in self._module.parameters())


def _state(model_or_params) -> Mapping[str, torch.Tensor]:
    if isinstance(model_or_params, nn.Module):
        return _Parameters(model_or_params)
    return model_or_params


def _layernorm(x, scale, bias):
    """LayerNorm with float32 math, result in x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), 1e-5)
    return y.to(x.dtype)


# the bf16 token chain's shapes and tile (csrc/fusion_chain_sm90.cuh:
# kWideC, kNarrowC, kHidden, kHeads, kRows); its MLP walks the hidden in
# chunks of C columns
CHAIN_WIDTHS = (304, 112)
CHAIN_HIDDEN = 256
CHAIN_HEADS = 4
TILE_TOKENS = 64


def chain_supported(C: int, hidden: int, mlp_hidden: int, heads: int) -> bool:
    """Whether the bf16 token chain (eval kernel and train forward) takes
    these widths: ``chain::supported`` of the kernel source."""
    return (C in CHAIN_WIDTHS and hidden == CHAIN_HIDDEN and mlp_hidden > 0
            and mlp_hidden % C == 0 and heads == CHAIN_HEADS)


def tile_walk(B: int, N: int, sms: int) -> List[List[Tuple[int, int, int]]]:
    """The bf16 chain's persistent walk, as the kernel takes it: one block
    per SM (or per tile, where there are fewer), block ``i`` taking tiles
    ``i, i + grid, ...`` of the ``B * ceil(N / TILE_TOKENS)`` (image, tile)
    pairs in image-major order. Returns each block's list of (image, first
    token, valid tokens); the last tile of an image is ragged where
    ``TILE_TOKENS`` does not divide N (its missing rows are zero on load
    and not stored)."""
    tiles = -(-N // TILE_TOKENS)
    total = B * tiles
    grid = min(total, sms)
    walk = []
    for block in range(grid):
        mine = []
        for t in range(block, total, grid):
            first = (t % tiles) * TILE_TOKENS
            mine.append((t // tiles, first, min(TILE_TOKENS, N - first)))
        walk.append(mine)
    return walk


# fusion_operands' weight-only operands, newest last: (dtype, device,
# [(weakref, _version, data_ptr) of each parameter read], operands)
_WEIGHT_CACHE: List[tuple] = []
_WEIGHT_CACHE_SIZE = 4


def _weight_names():
    pv, ca, blk = "visual_projector", "cross_att", "cross_att.blocks.0"
    return [f"{pv}.fc1.weight", f"{pv}.fc1.bias", f"{pv}.fc2.weight", f"{pv}.fc2.bias",
            f"{ca}.patch_embed_v.proj.weight", f"{ca}.patch_embed_v.proj.bias",
            f"{blk}.attn.proj.bias", f"{blk}.mlp.fc1.weight", f"{blk}.mlp.fc1.bias",
            f"{blk}.mlp.fc2.weight", f"{blk}.mlp.fc2.bias", f"{blk}.norm1.weight",
            f"{blk}.norm1.bias", f"{blk}.norm2.weight", f"{blk}.norm2.bias",
            f"{ca}.norm.weight", f"{ca}.norm.bias"]


def _derive_weights(p: Mapping[str, torch.Tensor], dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """The chain's weight-only operands in ``dtype``, matrices [in, out]."""
    w = lambda k: p[k].to(dtype)
    pv, ca, blk = "visual_projector", "cross_att", "cross_att.blocks.0"
    # fc2 @ patch_embed_v, folded in float32
    wpe = p[f"{ca}.patch_embed_v.proj.weight"].float().t()
    w2f = p[f"{pv}.fc2.weight"].float().t() @ wpe
    b2f = p[f"{pv}.fc2.bias"].float() @ wpe + p[f"{ca}.patch_embed_v.proj.bias"].float()
    ops = {
        "w1": w(f"{pv}.fc1.weight").t(), "b1": w(f"{pv}.fc1.bias"),
        "w2f": w2f.to(dtype), "b2f": b2f.to(dtype),
        "bp": w(f"{blk}.attn.proj.bias"),
        "wm1": w(f"{blk}.mlp.fc1.weight").t(), "bm1": w(f"{blk}.mlp.fc1.bias"),
        "wm2": w(f"{blk}.mlp.fc2.weight").t(), "bm2": w(f"{blk}.mlp.fc2.bias"),
        "n1s": w(f"{blk}.norm1.weight"), "n1b": w(f"{blk}.norm1.bias"),
        "n2s": w(f"{blk}.norm2.weight"), "n2b": w(f"{blk}.norm2.bias"),
        "n3s": w(f"{ca}.norm.weight"), "n3b": w(f"{ca}.norm.bias"),
    }
    return {k: v.contiguous() for k, v in ops.items()}


def _cached_weights(p: Mapping[str, torch.Tensor], dtype: torch.dtype
                    ) -> Dict[str, torch.Tensor]:
    """:func:`_derive_weights`, kept while every parameter it read is the
    same tensor at the same version (an in-place update bumps
    ``_version``; ``load_state_dict`` copies in place; a new tensor fails
    the identity check) and at the same address."""
    params = [p[k] for k in _weight_names()]
    device = params[0].device
    for i, (dt, dev, marks, ops) in enumerate(_WEIGHT_CACHE):
        if dt == dtype and dev == device and len(marks) == len(params) and all(
                ref() is t and ver == t._version and ptr == t.data_ptr()
                for (ref, ver, ptr), t in zip(marks, params)):
            _WEIGHT_CACHE.append(_WEIGHT_CACHE.pop(i))
            return ops
    ops = _derive_weights(p, dtype)
    marks = [(weakref.ref(t), t._version, t.data_ptr()) for t in params]
    _WEIGHT_CACHE.append((dtype, device, marks, ops))
    del _WEIGHT_CACHE[:-_WEIGHT_CACHE_SIZE]
    return ops


@torch.no_grad()
def fusion_operands(model_or_params: Union[nn.Module, Mapping[str, torch.Tensor]],
                    fea_a: torch.Tensor, dtype: torch.dtype, num_heads: int = 4
                    ) -> Dict[str, torch.Tensor]:
    """The kernel's operands in ``dtype``: the per-image rank-1 factors
    and the token chain's weights, with matrices laid out [in, out]. The
    weights come from a cache keyed on the parameters' identity and
    version (:func:`_cached_weights`); the audio side runs every call."""
    p = _state(model_or_params)
    w = lambda k: p[k].to(dtype)
    ca, blk = "cross_att", "cross_att.blocks.0"

    # the single audio token of each image
    B, C = fea_a.shape[0], fea_a.shape[-1]
    fa = fea_a.reshape(B, C).to(dtype)
    fa = fa @ w(f"{ca}.patch_embed_a.proj.weight").t() + w(f"{ca}.patch_embed_a.proj.bias")
    fan = _layernorm(fa, p[f"{blk}.norm1.weight"], p[f"{blk}.norm1.bias"])
    wqk, m = rank1_factors(p[f"{blk}.attn.q.weight"], p[f"{blk}.attn.proj.weight"],
                           fan @ w(f"{blk}.attn.k.weight").t(),
                           fan @ w(f"{blk}.attn.v.weight").t(), num_heads)
    return {"wqk": wqk.contiguous(), "m": m.contiguous(), **_cached_weights(p, dtype)}


def token_chain_reference(x: torch.Tensor, ops: Mapping[str, torch.Tensor],
                          num_heads: int = 4) -> torch.Tensor:
    """Plain PyTorch token chain with the kernel's rounding points:
    x [B, N, C] -> fused tokens [B, N, C] in x's dtype."""
    dt = x.dtype
    scale = (x.shape[-1] // num_heads) ** -0.5
    gelu = lambda t: F.gelu(t.float()).to(dt)
    h1 = gelu(x @ ops["w1"] + ops["b1"])
    a = _layernorm(h1 @ ops["w2f"] + ops["b2f"], ops["n1s"], ops["n1b"])
    s = torch.einsum("bnc,bch->bnh", a.float(), ops["wqk"].float())
    g = torch.sigmoid(s * scale).to(dt)
    o = torch.einsum("bnh,bhc->bnc", g.float(), ops["m"].float()).to(dt)
    t4 = a + (o + ops["bp"])
    h2 = gelu(_layernorm(t4, ops["n2s"], ops["n2b"]) @ ops["wm1"] + ops["bm1"])
    t5 = t4 + (h2 @ ops["wm2"] + ops["bm2"])
    return _layernorm(t5, ops["n3s"], ops["n3b"])


@torch.no_grad()
def fused_visual_fusion_reference(model_or_params, fea_v_tokens: torch.Tensor,
                                  fea_a: torch.Tensor, num_heads: int = 4
                                  ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_visual_fusion`, on any device."""
    ops = fusion_operands(model_or_params, fea_a, fea_v_tokens.dtype, num_heads)
    return token_chain_reference(fea_v_tokens, ops, num_heads)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with the C signatures declared."""
    from cavp_tpu_torch.ops._build import load_library

    lib = load_library()
    fn = lib.cavp_fused_visual_fusion
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cavp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cavp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, ops: Mapping[str, torch.Tensor], num_heads: int
            ) -> torch.Tensor:
    B, N, C = x.shape
    hidden, mlp_hidden = ops["w1"].shape[1], ops["wm1"].shape[1]
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid's 65535")
    # float32 runs on the CUDA cores (float4 rows); bf16 is the wgmma token
    # chain, built for the shapes of chain_supported
    if x.dtype == torch.float32 and (C % 4 or hidden % 4 or mlp_hidden % 4):
        raise ValueError(f"the float32 kernel needs C, hidden and mlp_hidden to be "
                         f"multiples of 4, got {C}, {hidden}, {mlp_hidden}")
    if x.dtype == torch.bfloat16 and not chain_supported(C, hidden, mlp_hidden, num_heads):
        raise ValueError(f"the bf16 kernel takes C in {CHAIN_WIDTHS}, hidden {CHAIN_HIDDEN}, "
                         f"mlp_hidden a multiple of C and {CHAIN_HEADS} heads, got "
                         f"{C}, {hidden}, {mlp_hidden}, {num_heads}")
    for k, v in ops.items():
        if v.device != x.device or v.dtype != x.dtype or not v.is_contiguous():
            raise ValueError(f"operand {k} must be a contiguous {x.dtype} "
                             f"tensor on {x.device}")
    lib = _library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.cavp_fused_visual_fusion(
        _DTYPE_CODE[x.dtype], x.data_ptr(), ops["wqk"].data_ptr(),
        ops["m"].data_ptr(), *(ops[k].data_ptr() for k in _CHAIN),
        out.data_ptr(), B, N, C, hidden, mlp_hidden, num_heads,
        (C // num_heads) ** -0.5, stream)
    if err != 0:
        msg = lib.cavp_cuda_error_string(err).decode()
        raise RuntimeError(f"fusion kernel launch failed: {msg} ({err})")
    return out


@torch.no_grad()
def fused_visual_fusion(model_or_params, fea_v_tokens: torch.Tensor,
                        fea_a: torch.Tensor, num_heads: int = 4) -> torch.Tensor:
    """The eval fusion stage: projector -> patch embeds -> depth-1 sigmoid
    cross-attention block -> final norm.

    model_or_params: a ``CAVP`` module, or its state dict (reference
    names). fea_v_tokens: [B, h*w, C] contiguous visual tokens in the IO
    dtype (float32 or bfloat16); fea_a: [B, C] audio feature. Returns the
    fused tokens [B, h*w, C], equal up to rounding to
    ``CAVP.forward_fusion``'s. Eval only: no gradient.

    CPU tensors take :func:`fused_visual_fusion_reference`; CUDA tensors
    launch the kernel (counted in ``fused_visual_fusion.launches``) or
    raise.
    """
    x = fea_v_tokens
    if x.dim() != 3 or fea_a.shape[0] != x.shape[0] or fea_a.shape[-1] != x.shape[-1]:
        raise ValueError(f"need tokens [B, N, C] and audio [B, C], got "
                         f"{tuple(x.shape)} and {tuple(fea_a.shape)}")
    if x.shape[-1] % num_heads:
        raise ValueError(f"C={x.shape[-1]} is not divisible by {num_heads} heads")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if x.device.type == "cpu":
        return fused_visual_fusion_reference(model_or_params, x, fea_a, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"no fusion kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("fea_v_tokens must be contiguous")
    ops = fusion_operands(model_or_params, fea_a, x.dtype, num_heads)
    out = _launch(x, ops, num_heads)
    fused_visual_fusion.launches += 1
    return out


fused_visual_fusion.launches = 0
