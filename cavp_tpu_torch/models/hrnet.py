"""HRNet-W48 backbone and the HRNetV2 segmentation head
(``cavp_tpu/models/hrnet.py``).

- stem: two stride-2 3x3 convs (3 -> 64 -> 64);
- layer1: four Bottlenecks of 64 planes (256 channels out);
- stages 2, 3 and 4 with ``STAGE_MODULES`` = (1, 4, 3) modules of 2, 3 and
  4 branches at (48, 96, 192, 384) channels, four BasicBlocks a branch, SUM
  fusion: a 1x1 conv + BN + bilinear (align_corners=True) upsample from a
  coarser branch, a chain of strided 3x3 conv + BN (ReLU between) from a
  finer one;
- head: the four branches upsampled (align_corners=True) and concatenated
  (720 channels, the fusion feature), then conv3x3 (bias) + BN + ReLU +
  channel dropout 0.10 and a bias-free 1x1 classifier.

Module names are the reference state dict's (``tests/torch_ref_variants.py``):
``backbone.{conv1,bn1,conv2,bn2}``, ``backbone.layer1.{i}.*``,
``backbone.transition{t}.{j}[.0].{0,1}`` (a new branch nests one more
Sequential), ``backbone.stage{s}.{m}.branches.{b}.{k}.*``,
``backbone.stage{s}.{m}.fuse_layers.{i}.{j}[.{k}].{0,1}``,
``segment.upsample.last_conv.{0,1}`` and ``segment.upsample.classifier``.

The head's ``Dropout2d`` drops whole channels in train mode; its keep mask
[B, 720] is an argument (the train step draws it), as the JAX package
draws it from the step's ``dropout`` key.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.layers import BatchNorm2d, Conv2d
from cavp_tpu_torch.models.resnet import Bottleneck

W48_CHANNELS = (48, 96, 192, 384)
STAGE_MODULES = (1, 4, 3)  # stages 2, 3, 4
BLOCKS_PER_BRANCH = 4
HEAD_DROPOUT = 0.10


def upsample_aligned(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the HRNet fusion and the
    branch concat)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def concat_branches(feats: List[torch.Tensor]) -> torch.Tensor:
    """The branch maps upsampled to the first one's size and concatenated
    on channels: 48 + 96 + 192 + 384 = 720."""
    h, w = feats[0].shape[-2:]
    return torch.cat([feats[0]] + [upsample_aligned(f, (h, w)) for f in feats[1:]], dim=1)


def channel_dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float,
                    training: bool) -> torch.Tensor:
    """``Dropout2d(rate)`` with its keep mask given: [B, C] bool over x
    [B, C, h, w]; kept channels are divided by the keep probability rounded
    to x's dtype (flax divides by the probability as a weak-typed constant).
    Identity in eval mode; in train mode the mask is required."""
    if not training:
        return x
    if keep is None:
        raise ValueError("in train mode the channel-dropout keep mask is an argument")
    if tuple(keep.shape) != tuple(x.shape[:2]):
        raise ValueError(f"keep mask {tuple(keep.shape)} does not fit {tuple(x.shape[:2])}")
    prob = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep[:, :, None, None], x / prob, torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, relu: bool = False) -> nn.Sequential:
    mods = [Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False), BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class BasicBlock(nn.Module):
    """3x3 -> BN/ReLU -> 3x3 -> BN, + residual, ReLU."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class HRModule(nn.Module):
    """Parallel branches of four BasicBlocks, then SUM fusion."""

    def __init__(self, num_branches: int):
        super().__init__()
        self.num_branches = num_branches
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(W48_CHANNELS[i]) for _ in range(BLOCKS_PER_BRANCH)])
            for i in range(num_branches)])
        fuse = []
        for i in range(num_branches):
            row = []
            for j in range(num_branches):
                if j > i:
                    row.append(_conv_bn(W48_CHANNELS[j], W48_CHANNELS[i], 1))
                elif j == i:
                    row.append(None)
                else:  # i - j strided 3x3 hops, ReLU between them
                    hops = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        out = W48_CHANNELS[i] if last else W48_CHANNELS[j]
                        hops.append(_conv_bn(W48_CHANNELS[j], out, 3, 2, relu=not last))
                    row.append(nn.Sequential(*hops))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for i in range(self.num_branches):
            y = None
            for j in range(self.num_branches):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = upsample_aligned(self.fuse_layers[i][j](ys[j]), ys[i].shape[-2:])
                else:
                    t = self.fuse_layers[i][j](ys[j])
                y = t if y is None else y + t
            out.append(F.relu(y))
        return out


class HRNetW48Backbone(nn.Module):
    """HighResolutionNet (W48): [B, 3, H, W] -> the four branch maps at
    1/4 ... 1/32 of the input."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(
            Bottleneck(64, 64, 1, 1, downsample=1),
            *[Bottleneck(256, 64, 1, 1, downsample=None) for _ in range(3)])
        # stage 2's transition adapts layer1's 256 channels to 48 and opens
        # the 96 branch; stages 3 and 4 only open a branch (nested Sequential)
        self.transition1 = nn.ModuleList([
            _conv_bn(256, W48_CHANNELS[0], 3, relu=True),
            nn.Sequential(_conv_bn(256, W48_CHANNELS[1], 3, 2, relu=True))])
        self.stage2 = nn.Sequential(*[HRModule(2) for _ in range(STAGE_MODULES[0])])
        self.transition2 = nn.ModuleList(
            [None, None, nn.Sequential(_conv_bn(W48_CHANNELS[1], W48_CHANNELS[2], 3, 2, relu=True))])
        self.stage3 = nn.Sequential(*[HRModule(3) for _ in range(STAGE_MODULES[1])])
        self.transition3 = nn.ModuleList(
            [None, None, None,
             nn.Sequential(_conv_bn(W48_CHANNELS[2], W48_CHANNELS[3], 3, 2, relu=True))])
        self.stage4 = nn.Sequential(*[HRModule(4) for _ in range(STAGE_MODULES[2])])

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [self.transition1[0](x), self.transition1[1](x)]
        for stage, transition in ((self.stage2, self.transition2),
                                  (self.stage3, self.transition3),
                                  (self.stage4, None)):
            xs = stage(xs)
            if transition is not None:
                xs = xs + [transition[len(xs)](xs[-1])]
        return xs


class _HeadUpsample(nn.Module):
    """conv3x3 (bias) + BN + ReLU + channel dropout, then the bias-free 1x1
    classifier: [B, 720, h, w] -> [B, classes, h, w]."""

    def __init__(self, num_classes: int, channels: int = 720):
        super().__init__()
        self.last_conv = nn.Sequential(
            Conv2d(channels, channels, 3, padding=1, bias=True), BatchNorm2d(channels), nn.ReLU())
        self.classifier = Conv2d(channels, num_classes, 1, bias=False)

    def forward(self, x, drop_mask: Optional[torch.Tensor] = None):
        f = channel_dropout(self.last_conv(x), drop_mask, HEAD_DROPOUT, self.training)
        return self.classifier(f)


class HRNetW48Head(nn.Module):
    """hrnetv2_w48: ``forward_feature`` is the 720-channel concat (the fusion
    feature, latent 720), ``upsample`` the classifier head."""

    dropout = HEAD_DROPOUT

    def __init__(self, num_classes: int):
        super().__init__()
        self.upsample = _HeadUpsample(num_classes)

    def forward_feature(self, feats: List[torch.Tensor]) -> torch.Tensor:
        return concat_branches(feats)

    def forward(self, feats, drop_mask=None):
        return self.upsample(self.forward_feature(feats), drop_mask)
