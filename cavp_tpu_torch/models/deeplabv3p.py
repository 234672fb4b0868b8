"""DeepLabV3+ segmentation head (``cavp_tpu/models/deeplabv3p.py``).

ASPP with rates (6, 12, 18) and a global-pool branch (LeakyReLU 0.01),
a 48-channel low-level ``reduce``, the ``forward_feature`` concat that
gives the 304-channel (112 for the small ASPP) fusion feature at 1/4
resolution, and the two-conv ``Upsampling`` classifier head. The hidden
width is 256 for every variant, as in the reference. Dilated 3x3 convs
run natively; the JAX package's tap decomposition (``ops/dilated.py``)
computes the same sums.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.layers import BatchNorm2d, Conv2d


class ASPP(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 256,
                 hidden_channels: int = 256, dilation_rates=(6, 12, 18)):
        super().__init__()
        h = hidden_channels
        self.map_convs = nn.ModuleList(
            [Conv2d(in_channels, h, 1, bias=False)]
            + [Conv2d(in_channels, h, 3, padding=r, dilation=r, bias=False)
               for r in dilation_rates])
        self.map_bn = BatchNorm2d(h * 4)
        self.global_pooling_conv = Conv2d(in_channels, h, 1, bias=False)
        self.global_pooling_bn = BatchNorm2d(h)
        self.red_conv = Conv2d(h * 4, out_channels, 1, bias=False)
        self.pool_red_conv = Conv2d(h, out_channels, 1, bias=False)
        self.red_bn = BatchNorm2d(out_channels)

    def forward(self, x):
        out = torch.cat([m(x) for m in self.map_convs], dim=1)
        out = self.red_conv(F.leaky_relu(self.map_bn(out), 0.01))
        pool = x.mean(dim=(2, 3), keepdim=True)
        pool = F.leaky_relu(self.global_pooling_bn(self.global_pooling_conv(pool)),
                            0.01)
        out = out + self.pool_red_conv(pool)  # broadcast over H, W
        return F.leaky_relu(self.red_bn(out), 0.01)


class Upsampling(nn.Module):
    """2x(conv3x3 + BN + ReLU), then the 1x1 classifier."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.last_conv = nn.Sequential(
            Conv2d(in_channels, 256, 3, padding=1, bias=False),
            BatchNorm2d(256), nn.ReLU(),
            Conv2d(256, 256, 3, padding=1, bias=False),
            BatchNorm2d(256), nn.ReLU(),
        )
        self.classifier = Conv2d(256, num_classes, 1, bias=True)

    def forward(self, x):
        return self.classifier(self.last_conv(x))


class DeepLabV3Plus(nn.Module):
    def __init__(self, num_classes: int, aspp_in_plane: int = 2048,
                 aspp_out_plane: int = 256, low_level_plane: int = 256):
        super().__init__()
        self.aspp = ASPP(aspp_in_plane, aspp_out_plane)
        # reduce reads c1 (layer1's 256 channels at every depth); the
        # reference sizes it by aspp_out_plane, which only agrees at 256
        self.reduce = nn.Sequential(
            Conv2d(low_level_plane, 48, 1, bias=False), BatchNorm2d(48), nn.ReLU())
        self.upsample = Upsampling(aspp_out_plane + 48, num_classes)

    def forward_feature(self, f_list):
        """[c1..c4] -> ASPP(c4) upsampled (align_corners=True) to c1's
        size, concatenated with the reduced c1: [B, out+48, h, w]."""
        f = self.aspp(f_list[-1])
        low = self.reduce(f_list[0])
        f = F.interpolate(f, size=low.shape[-2:], mode="bilinear",
                          align_corners=True)
        return torch.cat([f, low], dim=1)

    def forward(self, f_list):
        return self.upsample(self.forward_feature(f_list))
