"""OCR (object-contextual representations) head on the HRNet-W48 backbone
(``cavp_tpu/models/ocr.py``).

On the 720-channel branch concat: an auxiliary head (conv3x3 + BN + ReLU +
1x1, biases) gives class logits; conv3x3 720 -> 512 gives the pixel
features; ``SpatialGather`` turns the auxiliary logits (softmax over the
pixels, float32) into one proxy per class; ``ObjectAttention`` lets each
pixel attend to the proxies (softmax over the classes at 256^-1/2); the
1x1 bottleneck over [context, features] (1024 -> 512) and its channel
dropout 0.05 give the fusion feature (latent 512); the classifier is a 1x1
conv with a bias. Only the main logits leave the head, as in the reference.

Module names are the reference state dict's: ``segment.conv3x3.{0,1}``,
``segment.ocr_distri_head.object_context_block.{f_pixel,f_object}.{0,1,3,4}``,
``...{f_down,f_up}.{0,1}``, ``segment.ocr_distri_head.conv_bn_dropout.{0,1}``,
``segment.aux_head.{0,1,3}``, ``segment.upsample``. The bottleneck's keep
mask [B, 512] is an argument in train mode.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from cavp_tpu_torch.models.hrnet import channel_dropout, concat_branches
from cavp_tpu_torch.models.layers import BatchNorm2d, Conv2d, acc_dtype

BOTTLENECK_DROPOUT = 0.05
KEY_CHANNELS = 256


def _conv_bn_relu(cin: int, cout: int, k: int = 1) -> List[nn.Module]:
    return [Conv2d(cin, cout, k, padding=k // 2, bias=True), BatchNorm2d(cout), nn.ReLU()]


def spatial_gather(feats: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Class proxies: feats [B, C, h, w], logits [B, K, h, w] -> [B, K, C],
    the feature means weighted by the float32 softmax of each class over
    the pixels, in feats' dtype."""
    B, C = feats.shape[:2]
    adt = acc_dtype(feats.dtype)
    probs = torch.softmax(logits.reshape(B, logits.shape[1], -1).to(adt), dim=-1)
    f = feats.reshape(B, C, -1).to(adt)
    return torch.bmm(probs, f.transpose(1, 2)).to(feats.dtype)


class ObjectContextBlock(nn.Module):
    """Pixels attend to the class proxies (``_ObjectAttentionBlock``, scale 1)."""

    def __init__(self, in_channels: int = 512, key_channels: int = KEY_CHANNELS):
        super().__init__()
        kc = key_channels
        self.key_channels = kc
        self.f_pixel = nn.Sequential(*_conv_bn_relu(in_channels, kc), *_conv_bn_relu(kc, kc))
        self.f_object = nn.Sequential(*_conv_bn_relu(in_channels, kc), *_conv_bn_relu(kc, kc))
        self.f_down = nn.Sequential(*_conv_bn_relu(in_channels, kc))
        self.f_up = nn.Sequential(*_conv_bn_relu(kc, in_channels))

    def forward(self, x: torch.Tensor, proxy: torch.Tensor) -> torch.Tensor:
        """x [B, C, h, w], proxy [B, K, C] -> context [B, C, h, w]."""
        B, _, h, w = x.shape
        kc = self.key_channels
        proxy_map = proxy.transpose(1, 2).unsqueeze(-1)  # [B, C, K, 1]
        query = self.f_pixel(x).reshape(B, kc, h * w).transpose(1, 2)   # [B, hw, kc]
        key = self.f_object(proxy_map).reshape(B, kc, -1)               # [B, kc, K]
        value = self.f_down(proxy_map).reshape(B, kc, -1).transpose(1, 2)  # [B, K, kc]
        sim = torch.bmm(query, key) * (kc ** -0.5)
        sim = torch.softmax(sim.to(acc_dtype(sim.dtype)), dim=-1).to(x.dtype)
        context = torch.bmm(sim, value)                                  # [B, hw, kc]
        context = context.transpose(1, 2).reshape(B, kc, h, w)
        return self.f_up(context)


class _DistriHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.object_context_block = ObjectContextBlock()
        self.conv_bn_dropout = nn.Sequential(*_conv_bn_relu(1024, 512))


class OCRHead(nn.Module):
    dropout = BOTTLENECK_DROPOUT

    def __init__(self, num_classes: int):
        super().__init__()
        self.conv3x3 = nn.Sequential(*_conv_bn_relu(720, 512, 3))
        self.ocr_distri_head = _DistriHead()
        self.upsample = Conv2d(512, num_classes, 1, bias=True)
        self.aux_head = nn.Sequential(*_conv_bn_relu(720, 720, 3),
                                      Conv2d(720, num_classes, 1, bias=True))

    def forward_feature(self, feats: List[torch.Tensor],
                        drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The four branch maps -> the 512-channel fusion feature."""
        x = concat_branches(feats)
        out_aux = self.aux_head(x)
        f = self.conv3x3(x)
        context = self.ocr_distri_head.object_context_block(f, spatial_gather(f, out_aux))
        f = self.ocr_distri_head.conv_bn_dropout(torch.cat([context, f], dim=1))
        return channel_dropout(f, drop_mask, BOTTLENECK_DROPOUT, self.training)

    def forward(self, feats, drop_mask=None):
        return self.upsample(self.forward_feature(feats, drop_mask))
