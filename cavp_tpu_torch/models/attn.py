"""Cross-modal sigmoid attention fusion at eval (``cavp_tpu/models/attn.py``).

- attention weights are **sigmoid**, not softmax;
- q/k/v projections have no bias;
- ``Block`` applies one shared ``norm1`` to both modalities and the
  residual accumulates on the *normed* visual tokens;
- the positional embeddings are allocated but unused (kept so the
  reference state dict loads strictly).

With one audio token the visual->audio attention is a rank-1 gate, so the
q and output projections fold into per-image ``[C, heads]`` and
``[heads, C]`` factors (``Attention.collapse_rank1`` in the JAX package,
``attn.py:183-205``)::

    gate[t, h] = sigmoid(x_q[t] @ (Wq_h @ k_h) * hd**-0.5)
    out[t]     = gate[t] @ (v_h @ Wp_h) + bp

The block's second step, the audio token attending the updated visual
tokens, is not computed: ``CAVP.forward_fusion`` discards its result on
every path (XLA removes it under ``jit`` in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cavp_tpu_torch.models.layers import LayerNorm, Linear, Mlp


def rank1_factors(q_weight, proj_weight, k, v, num_heads: int):
    """Per-image folds of the q and output projections.

    ``q_weight``/``proj_weight``: torch-layout [C_out, C_in] weights;
    ``k``/``v``: the single audio token's projections [B, C]. Returns
    ``wqk`` [B, C, heads] and ``m`` [B, heads, C] in ``k``'s dtype."""
    B, C = k.shape
    hd = C // num_heads
    dt = k.dtype
    wq = q_weight.to(dt).t().reshape(C, num_heads, hd)       # [C_in, h, hd]
    wp = proj_weight.to(dt).t().reshape(num_heads, hd, C)    # [h, hd, C_out]
    wqk = torch.einsum("chd,bhd->bch", wq, k.reshape(B, num_heads, hd))
    m = torch.einsum("bhd,hdc->bhc", v.reshape(B, num_heads, hd), wp)
    return wqk, m


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim, bias=False)
        self.k = Linear(dim, dim, bias=False)
        self.v = Linear(dim, dim, bias=False)
        self.proj = Linear(dim, dim)

    def forward(self, x_q, x_kv):
        """x_q [B, N, C] visual tokens; x_kv [B, 1, C] the audio token.
        Returns (out [B, N, C], attn [B, heads, N, 1])."""
        if x_kv.shape[1] != 1:
            raise NotImplementedError("only the single-audio-token eval "
                                      "attention is ported")
        C = x_q.shape[-1]
        scale = (C // self.num_heads) ** -0.5
        wqk, m = rank1_factors(self.q.weight, self.proj.weight,
                               self.k(x_kv)[:, 0], self.v(x_kv)[:, 0],
                               self.num_heads)
        gate = torch.sigmoid(torch.einsum("bnc,bch->bnh", x_q, wqk) * scale)
        out = torch.einsum("bnh,bhc->bnc", gate, m) + self.proj.bias.to(x_q.dtype)
        return out, gate.transpose(1, 2)[..., None]


class Block(nn.Module):
    """``attn.py:109-171`` mode "CA", visual side at dup=1."""

    def __init__(self, dim: int, num_heads: int = 4, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, f_v, f_a):
        f_v = self.norm1(f_v)
        out, attn_v = self.attn(f_v, self.norm1(f_a))
        f_v = f_v + out
        f_v = f_v + self.mlp(self.norm2(f_v))
        return f_v, attn_v


class PatchEmbed(nn.Module):
    """Tokens -> tokens through a linear ``proj`` (the reference flattens
    a map first; callers here pass tokens)."""

    def __init__(self, dim_in: int, embed_dim: int):
        super().__init__()
        self.proj = Linear(dim_in, embed_dim)

    def forward(self, x):
        return self.proj(x)


class CrossAttention(nn.Module):
    """``CROSS_ATTENTION``, depth 1 and 4 heads in CAVP."""

    def __init__(self, embed_dim: int, depth: int = 1, num_heads: int = 4,
                 mlp_ratio: float = 4.0, num_patches_v: int = 128 * 128):
        super().__init__()
        if depth != 1:
            raise NotImplementedError(
                "depth 1 only: a deeper stack reads the audio-side update, "
                "which is not ported")
        self.num_heads = num_heads
        self.patch_embed_v = PatchEmbed(embed_dim, embed_dim)
        self.patch_embed_a = PatchEmbed(embed_dim, embed_dim)
        self.pos_embed_v = nn.Parameter(torch.zeros(1, num_patches_v, embed_dim))
        self.pos_embed_a = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)])
        self.norm = LayerNorm(embed_dim)

    def forward(self, f_v, f_a):
        """f_v [B, N, C] visual tokens, f_a [B, 1, C] audio token ->
        (fused tokens [B, N, C], attn_v [B, heads, N, 1])."""
        f_v = self.patch_embed_v(f_v)
        f_a = self.patch_embed_a(f_a)
        attn_v = None
        for block in self.blocks:
            f_v, attn_v = block(f_v, f_a)
        return self.norm(f_v), attn_v
