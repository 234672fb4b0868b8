"""Deep-stem ResNet backbone, segmentation flavour
(``cavp_tpu/models/resnet.py``).

- every depth uses Bottleneck blocks: depth 18 is Bottleneck (2,2,2,2),
  not torchvision's BasicBlock net;
- deep stem: 3x(3x3) convs 3->64->64->128, stride 2 on the first, then
  maxpool 3x3/2;
- ``replace_stride_with_dilation`` turns a stage's stride into dilation;
- layer4 always gets the ``_nostride_dilate`` surgery: stride-2 convs
  become stride 1 and block i's 3x3 conv gets dilation 2*2**i.

The per-block schedule comes from :func:`stage_specs`, the same function
as the JAX package's. Module names are the reference state dict's:
``backbone.backbone.conv1.{0,1,3,4,6}``, ``backbone.backbone.bn1``,
``backbone.backbone.layer{i}.{j}.{conv1..3,bn1..3,downsample.0/1}``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.layers import BatchNorm2d, Conv2d

EXPANSION = 4

RESNET_LAYERS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def stage_specs(layers: Sequence[int],
                replace_stride_with_dilation: Sequence[bool],
                nostride_dilate_layer4: bool = True) -> List[List[dict]]:
    """The torch constructor + layer4 surgery as a static schedule: for
    each stage a list of block dicts {stride, dilation, downsample}."""
    rswd = list(replace_stride_with_dilation)
    dilation = 1
    inplanes = 128  # deep stem output
    specs: List[List[dict]] = []
    for stage_idx, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stride = 1 if stage_idx == 0 else 2
        dilate = False if stage_idx == 0 else rswd[stage_idx - 1]
        previous_dilation = dilation
        if dilate:
            dilation *= stride
            stride = 1
        stage = []
        for b in range(blocks):
            if b == 0:
                needs_down = stride != 1 or inplanes != planes * EXPANSION
                stage.append(dict(stride=stride, dilation=previous_dilation,
                                  downsample=stride if needs_down else None))
                inplanes = planes * EXPANSION
            else:
                stage.append(dict(stride=1, dilation=dilation, downsample=None))
        specs.append(stage)

    if nostride_dilate_layer4:
        dilate = 2
        for block in specs[3]:
            if block["stride"] == 2:
                block["stride"] = 1
                if block["downsample"] == 2:
                    block["downsample"] = 1
            block["dilation"] = dilate
            dilate *= 2
    return specs


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1 x4, + residual."""

    def __init__(self, inplanes: int, planes: int, stride: int, dilation: int,
                 downsample):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * EXPANSION, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * EXPANSION)
        self.downsample = None
        if downsample is not None:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes * EXPANSION, 1, stride=downsample,
                       bias=False),
                BatchNorm2d(planes * EXPANSION))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Deep-stem ResNet returning the four stage features [c1..c4]."""

    def __init__(self, depth: int = 50,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False),
                 nostride_dilate_layer4: bool = True, stem_width: int = 64):
        super().__init__()
        sw = stem_width
        self.conv1 = nn.Sequential(
            Conv2d(3, sw, 3, stride=2, padding=1, bias=False),
            BatchNorm2d(sw), nn.ReLU(),
            Conv2d(sw, sw, 3, stride=1, padding=1, bias=False),
            BatchNorm2d(sw), nn.ReLU(),
            Conv2d(sw, sw * 2, 3, stride=1, padding=1, bias=False),
        )
        self.bn1 = BatchNorm2d(sw * 2)
        specs = stage_specs(RESNET_LAYERS[depth], replace_stride_with_dilation,
                            nostride_dilate_layer4)
        inplanes = sw * 2
        for stage_idx, stage in enumerate(specs):
            planes = (64, 128, 256, 512)[stage_idx]
            blocks = []
            for spec in stage:
                blocks.append(Bottleneck(inplanes, planes, spec["stride"],
                                         spec["dilation"], spec["downsample"]))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{stage_idx + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            feats.append(x)
        return feats


class Backbone(nn.Module):
    """The reference's encoder-decoder wrapper (``encoder_decoder.py:14-59``),
    whose only child is the ResNet, named ``backbone``."""

    def __init__(self, depth: int = 50,
                 replace_stride_with_dilation: Sequence[bool] = (False, False, False)):
        super().__init__()
        self.backbone = ResNet(depth, replace_stride_with_dilation)

    def forward(self, x):
        return self.backbone(x)
