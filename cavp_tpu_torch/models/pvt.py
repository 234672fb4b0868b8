"""PVT-v2 backbone, b0..b5 (``cavp_tpu/models/pvt.py``).

Four stages, each an overlapping patch embed (conv 7/4 then 3/2, bias, and
a LayerNorm), blocks of spatial-reduction attention (an ``sr`` conv of
stride ``SR_RATIOS[i]`` and a LayerNorm on the keys' side) and a
depthwise-conv MLP (fc1 -> 3x3 depthwise conv -> exact GELU -> fc2), and a
trailing LayerNorm; it returns the four stage maps. CAVP runs ``b5`` under
a small-ASPP DeepLabV3+ (latent 112). Stochastic depth is identity, as in
the JAX package.

Every LayerNorm has eps 1e-6 and, as flax's ``nn.LayerNorm`` with float32
parameters does, returns float32 for a bf16 input: the token stream and the
residual adds stay float32, and each dense and conv layer casts its input
to the compute dtype (the dtype of the image the backbone is given). The
stage maps are cast to the compute dtype once at the end, where the JAX
package's DeepLab convs cast them at their inputs (only the ASPP's global
mean differs: over the cast values here).

Module names are the reference state dict's: ``backbone.patch_embed{i}.
{proj,norm}``, ``backbone.block{i}.{j}.{norm1,attn.{q,kv,proj,sr,norm},
norm2,mlp.{fc1,dwconv.dwconv,fc2}}``, ``backbone.norm{i}``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.layers import Conv2d, Linear, acc_dtype

PVT_CONFIGS = {
    "b0": dict(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b1": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b2": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b3": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b4": dict(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b5": dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(4, 4, 4, 4)),
}
SR_RATIOS = (8, 4, 2, 1)
LN_EPS = 1e-6


class LayerNorm(nn.LayerNorm):
    """eps 1e-6, float32 math and a float32 (at least) result."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        adt = acc_dtype(x.dtype)
        return F.layer_norm(x.to(adt), self.normalized_shape, self.weight.to(adt),
                            self.bias.to(adt), self.eps)


def _conv_tokens(conv: nn.Module, t: torch.Tensor, H: int, W: int, dt) -> torch.Tensor:
    """A conv over tokens [B, H*W, C] in the compute dtype -> [B, H'*W', C']."""
    B, _, C = t.shape
    x = conv(t.to(dt).reshape(B, H, W, C).permute(0, 3, 1, 2))
    return x.permute(0, 2, 3, 1).reshape(B, -1, x.shape[1])


class SRAttention(nn.Module):
    """Softmax attention with spatially reduced keys and values."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, dim * 2)
        self.proj = Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim)

    def forward(self, x, H: int, W: int, dt):
        B, N, C = x.shape
        h, hd = self.num_heads, C // self.num_heads
        q = self.q(x.to(dt))
        xs = self.norm(_conv_tokens(self.sr, x, H, W, dt)) if self.sr_ratio > 1 else x
        k, v = self.kv(xs.to(dt)).split(C, dim=-1)
        q = q.reshape(B, N, h, hd).transpose(1, 2)
        k = k.reshape(B, -1, h, hd).transpose(1, 2)
        v = v.reshape(B, -1, h, hd).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-2, -1)) * (hd ** -0.5)
        attn = torch.softmax(attn.to(acc_dtype(attn.dtype)), dim=-1).to(q.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim, bias=True)


class DWConvMlp(nn.Module):
    """fc1 -> 3x3 depthwise conv -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, H: int, W: int, dt):
        x = _conv_tokens(self.dwconv.dwconv, self.fc1(x.to(dt)), H, W, dt)
        return self.fc2(F.gelu(x))


class PVTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, sr_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.mlp = DWConvMlp(dim, dim * mlp_ratio)

    def forward(self, x, H: int, W: int, dt):
        x = x + self.attn(self.norm1(x), H, W, dt)
        return x + self.mlp(self.norm2(x), H, W, dt)


class _PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = Conv2d(cin, dim, patch, stride=stride, padding=patch // 2)
        self.norm = LayerNorm(dim)


class PVTv2(nn.Module):
    """[B, 3, H, W] in the compute dtype -> the four stage maps
    [B, C1, H/4, W/4] ... [B, C4, H/32, W/32], in that dtype."""

    def __init__(self, variant: str = "b5"):
        super().__init__()
        cfg = PVT_CONFIGS[variant]
        self.embed_dims = cfg["embed_dims"]
        cin = 3
        for i in range(4):
            dim = cfg["embed_dims"][i]
            patch, stride = (7, 4) if i == 0 else (3, 2)
            setattr(self, f"patch_embed{i + 1}", _PatchEmbed(cin, dim, patch, stride))
            setattr(self, f"block{i + 1}", nn.ModuleList([
                PVTBlock(dim, cfg["num_heads"][i], cfg["mlp_ratios"][i], SR_RATIOS[i])
                for _ in range(cfg["depths"][i])]))
            setattr(self, f"norm{i + 1}", LayerNorm(dim))
            cin = dim

    def forward(self, x) -> List[torch.Tensor]:
        dt = x.dtype
        outs = []
        for i in range(1, 5):
            pe = getattr(self, f"patch_embed{i}")
            x = pe.proj(x.to(dt))
            B, C, H, W = x.shape
            t = pe.norm(x.permute(0, 2, 3, 1).reshape(B, H * W, C))
            for block in getattr(self, f"block{i}"):
                t = block(t, H, W, dt)
            t = getattr(self, f"norm{i}")(t)
            x = t.reshape(B, H, W, C).permute(0, 3, 1, 2)
            outs.append(x.to(dt))
        return outs
