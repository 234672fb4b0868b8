"""Audio encoder towers (``cavp_tpu/models/audio_nets.py``).

- :class:`VGGAudio` (1 s of audio, the AVS setups): the VGGish conv stack
  [64,M,128,M,256,256,M,512,512,M] on the 1-channel log-mel [N,1,96,64],
  then a 3-layer MLP 12288->4096->4096->out with ReLU after every linear;
- :class:`AudioResNet18` (3 s of audio, the VPO setups): torchvision's
  BasicBlock ResNet-18 with an ``in_plane``-channel stem (2 for stereo),
  train-mode BatchNorm, a global max pool and ``Linear(512, out)``
  (``audio_network.py:19-25``), on the log-mel [N,in_plane,300,64].

Module names are the reference's (``audio_backbone.backbone.features.N``,
``.embeddings.N``; torchvision's ``conv1``, ``bn1``,
``layer{1..4}.{0,1}.{conv1,bn1,conv2,bn2,downsample.0/1}``, ``fc``;
``audio_backbone.cls_head``).
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from cavp_tpu_torch.models.layers import BatchNorm2d, Conv2d, Linear


class VGGAudio(nn.Module):
    def __init__(self, out_plane: int, in_plane: int = 1):
        super().__init__()
        layers, in_c = [], in_plane
        for v in (64, "M", 128, "M", 256, 256, "M", 512, 512, "M"):
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(in_c, v, 3, padding=1), nn.ReLU()]
                in_c = v
        self.features = nn.Sequential(*layers)
        self.embeddings = nn.Sequential(
            Linear(512 * 4 * 6, 4096), nn.ReLU(),
            Linear(4096, 4096), nn.ReLU(),
            Linear(4096, out_plane), nn.ReLU(),
        )

    def forward(self, x):
        x = self.features(x)
        # flatten in (H, W, C) order: the reference's double transpose
        # (vgg.py:18-22) before embeddings.0, not torch's NCHW flatten
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.embeddings(x)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: 3x3 (stride) -> BN/ReLU -> 3x3 -> BN
    (+ 1x1 downsample and BN) -> + residual -> ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride=stride, bias=False), BatchNorm2d(planes))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class AudioResNet18(nn.Module):
    def __init__(self, out_plane: int, in_plane: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_plane, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for i, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(inplanes, planes, stride), BasicBlock(planes, planes)))
            inplanes = planes
        self.fc = Linear(512, out_plane)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return self.fc(x.amax(dim=(2, 3)))


class AudioModel(nn.Module):
    """Backbone (``"vgg"`` or ``"18"``) plus the classification head the
    reference allocates but never calls in ``forward`` (kept so checkpoints
    load strictly)."""

    def __init__(self, backbone: str = "vgg", out_plane: int = 304,
                 in_plane: int = 1, num_classes: int = 2):
        super().__init__()
        if backbone == "vgg":
            self.backbone = VGGAudio(out_plane, in_plane)
        else:
            self.backbone = AudioResNet18(out_plane, in_plane)
        self.cls_head = Linear(out_plane, num_classes)

    def forward(self, x):
        return self.backbone(x)
