"""CAVP model assembly for the DeepLabV3+ eval path (``cavp_tpu/models/cavp.py``).

- visual backbone: deep-stem ResNet + DeepLabV3+, giving the
  1/4-resolution fusion feature (304 channels; 112 for depth 18);
- ``visual_projector``: Mlp(latent, 256, latent) over tokens;
- sigmoid cross-attention fusion, depth 1;
- classifier head + bilinear (align_corners=False) upsample to the input
  resolution.

The four-method split of the JAX package is kept
(``forward_visual_feature`` / ``forward_audio_feature`` /
``forward_fusion`` / ``forward_cls``), because the fusion kernel wires in
between them. The methods take and return NCHW tensors; the engine
converts from and to the public NHWC layouts. Inputs are cast to the
compute dtype at the top of each tower, as the JAX convs cast theirs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.attn import CrossAttention
from cavp_tpu_torch.models.audio_nets import AudioModel
from cavp_tpu_torch.models.deeplabv3p import DeepLabV3Plus
from cavp_tpu_torch.models.layers import Mlp
from cavp_tpu_torch.models.resnet import Backbone


def map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, h*w, C]; a view for a channels_last map."""
    B, C, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, h * w, C)


def tokens_to_map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, h*w, C] -> [B, C, h, w] in channels_last memory format (a view)."""
    B, N, C = t.shape
    return t.reshape(B, h, w, C).permute(0, 3, 1, 2)


class CAVP(nn.Module):
    def __init__(self, num_classes: int = 71, seg_model: str = "DeepLabV3Plus",
                 visual_backbone: int = 50,
                 last_three_dilation_stride: Sequence[bool] = (False, False, False),
                 audio_backbone: str = "vgg", in_plane: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if seg_model != "DeepLabV3Plus":
            raise NotImplementedError(f"seg_model {seg_model!r} is not ported yet")
        self.dtype = dtype
        big = visual_backbone in (50, 101)
        # 304 = ASPP 256 + reduced low-level 48; depth 18 uses the small
        # ASPP (64 + 48), as in the JAX package's latent_dim
        self.latent_dim = 304 if big else 112
        self.backbone = Backbone(visual_backbone, tuple(last_three_dilation_stride))
        self.segment = DeepLabV3Plus(num_classes, aspp_in_plane=2048,
                                     aspp_out_plane=256 if big else 64)
        self.cross_att = CrossAttention(self.latent_dim, depth=1, num_heads=4)
        self.visual_projector = Mlp(self.latent_dim, 256, self.latent_dim)
        self.audio_backbone = AudioModel(audio_backbone, self.latent_dim, in_plane)

    def forward_visual_feature(self, image):
        """[B, 3, H, W] -> [B, latent, H/4, W/4]."""
        return self.segment.forward_feature(self.backbone(image.to(self.dtype)))

    def forward_audio_feature(self, audio):
        """[B, Cin, T, 64] log-mel -> [B, latent]."""
        return self.audio_backbone(audio.to(self.dtype))

    def forward_fusion(self, fea_v, fea_a):
        """fea_v [B, C, h, w], fea_a [B, C] -> (fused [B, C, h, w], pack)."""
        B, C, h, w = fea_v.shape
        tokens = self.visual_projector(map_to_tokens(fea_v))
        fused, attn_v = self.cross_att(tokens, fea_a.reshape(B, 1, C))
        return tokens_to_map(fused, h, w), {
            "audio": fea_a, "visual": tokens_to_map(tokens, h, w),
            "attn_v": attn_v}

    def forward_cls(self, fused, out_hw: Tuple[int, int]):
        """Head + align_corners=False upsample: -> [B, classes, H, W]."""
        logits = self.segment.upsample(fused)
        return F.interpolate(logits, size=tuple(out_hw), mode="bilinear",
                             align_corners=False)

    def forward(self, image, audio):
        """Eval forward: image [B, 3, H, W], audio [B, Cin, T, 64] ->
        (logits, fused, pack)."""
        fea_v = self.forward_visual_feature(image)
        fea_a = self.forward_audio_feature(audio)
        fused, pack = self.forward_fusion(fea_v, fea_a)
        return self.forward_cls(fused, image.shape[-2:]), fused, pack
