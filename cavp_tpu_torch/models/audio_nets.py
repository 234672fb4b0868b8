"""Audio encoder tower (``cavp_tpu/models/audio_nets.py``): the VGGish
conv stack [64,M,128,M,256,256,M,512,512,M] on the 1-channel log-mel
[N,1,96,64], then a 3-layer MLP 12288->4096->4096->out with ReLU after
every linear. Module names are the reference's
(``audio_backbone.backbone.features.N``, ``.embeddings.N``,
``audio_backbone.cls_head``). The ResNet-18 tower of the 3-s setups is
not ported yet.
"""

from __future__ import annotations

import torch.nn as nn

from cavp_tpu_torch.models.layers import Conv2d, Linear


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


class AudioModel(nn.Module):
    """Backbone plus the classification head the reference allocates but
    never calls in ``forward`` (kept so checkpoints load strictly)."""

    def __init__(self, backbone: str = "vgg", out_plane: int = 304,
                 in_plane: int = 1, num_classes: int = 2):
        super().__init__()
        if backbone != "vgg":
            raise NotImplementedError(
                f"audio backbone {backbone!r} is not ported yet")
        self.backbone = VGGAudio(out_plane, in_plane)
        self.cls_head = Linear(out_plane, num_classes)

    def forward(self, x):
        return self.backbone(x)
