"""CAVP model assembly for the DeepLabV3+ paths (``cavp_tpu/models/cavp.py``).

- visual backbone: deep-stem ResNet + DeepLabV3+, giving the
  1/4-resolution fusion feature (304 channels; 112 for depth 18);
- ``visual_projector``: Mlp(latent, 256, latent) over tokens;
- sigmoid cross-attention fusion, depth 1;
- classifier head + bilinear (align_corners=False) upsample to the input
  resolution.

The four-method split of the JAX package is kept
(``forward_visual_feature`` / ``forward_audio_feature`` /
``forward_fusion`` / ``forward_cls``), because the fusion kernels wire in
between them. The methods take and return NCHW tensors; the engine
converts from and to the public NHWC layouts. Inputs are cast to the
compute dtype at the top of each tower, as the JAX convs cast theirs.

Train or eval is the module's mode (``model.train()`` / ``.eval()``),
which decides what BatchNorm does. The decomposed methods also take the
JAX package's ``train`` argument: given, it overrides the mode for that
call. On the train path (``forward_train``) one visual batch B meets the
matched and the shuffled audio features, 2B rows, at ``dup=2``; with
``cls_matched_only`` (the JAX package's default, ``cavp.py:75-89``) the
head runs on the matched half only, so its BatchNorm sees B samples.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

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


@contextlib.contextmanager
def _mode(module: nn.Module, train: Optional[bool]):
    """Run a block with ``module`` in train or eval mode; ``None`` keeps
    the mode it has."""
    if train is None or train == module.training:
        yield
        return
    previous = module.training
    module.train(train)
    try:
        yield
    finally:
        module.train(previous)


class CAVP(nn.Module):
    def __init__(self, num_classes: int = 71, seg_model: str = "DeepLabV3Plus",
                 visual_backbone: int = 50,
                 last_three_dilation_stride: Sequence[bool] = (False, False, False),
                 audio_backbone: str = "vgg", in_plane: int = 1,
                 dtype: torch.dtype = torch.float32,
                 cls_matched_only: bool = True):
        super().__init__()
        if seg_model != "DeepLabV3Plus":
            raise NotImplementedError(f"seg_model {seg_model!r} is not ported yet")
        self.dtype = dtype
        self.seg_model = seg_model
        self.cls_matched_only = cls_matched_only
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

    def forward_visual_feature(self, image, train: Optional[bool] = None):
        """[B, 3, H, W] -> [B, latent, H/4, W/4]."""
        with _mode(self, train):
            return self.segment.forward_feature(self.backbone(image.to(self.dtype)))

    def forward_audio_feature(self, audio, train: Optional[bool] = None):
        """[B, Cin, T, 64] log-mel -> [B, latent]."""
        with _mode(self, train):
            return self.audio_backbone(audio.to(self.dtype))

    def forward_fusion(self, fea_v, fea_a, dup: int = 1):
        """fea_v [B, C, h, w], fea_a [dup*B, C] -> (fused [dup*B, C, h, w],
        pack). ``dup=2`` is the train path: the projector, the patch
        embed, norm1 and the query side run once on B."""
        B, C, h, w = fea_v.shape
        tokens = self.visual_projector(map_to_tokens(fea_v))
        fused, attn_v = self.cross_att(tokens, fea_a.reshape(dup * B, 1, C), dup)
        visual = tokens_to_map(tokens, h, w)
        if dup > 1:  # the shape the reference's duplicated batch has
            visual = visual.repeat(dup, 1, 1, 1)
        return tokens_to_map(fused, h, w), {
            "audio": fea_a, "visual": visual, "attn_v": attn_v}

    def forward_cls(self, fused, out_hw: Tuple[int, int],
                    train: Optional[bool] = None):
        """Head + align_corners=False upsample: -> [B, classes, H, W]."""
        with _mode(self, train):
            logits = self.segment.upsample(fused)
        return F.interpolate(logits, size=tuple(out_hw), mode="bilinear",
                             align_corners=False)

    def forward_inference(self, image, audio):
        """Eval forward: image [B, 3, H, W], audio [B, Cin, T, 64] ->
        (logits, fused, pack)."""
        fea_v = self.forward_visual_feature(image)
        fea_a = self.forward_audio_feature(audio)
        fused, pack = self.forward_fusion(fea_v, fea_a)
        return self.forward_cls(fused, image.shape[-2:]), fused, pack

    def forward_train(self, image, audio, audio_gather_idx=None):
        """Train forward (``cavp.py:202-236``), in the module's mode.

        ``audio_gather_idx=None``: ``audio`` is the [2B, ...] batch,
        matched then shuffled. With an index [B], ``audio`` holds the B
        matched clips first (then any extra rows, the train step's bank
        slots) and the shuffled half is the feature gather
        ``fea_a[audio_gather_idx]``. Returns (logits [B or 2B, classes,
        H, W], fused [2B, C, h, w], pack)."""
        B = image.shape[0]
        fea_v = self.forward_visual_feature(image)
        fea_a = self.forward_audio_feature(audio)
        if audio_gather_idx is not None:
            fea_a = torch.cat([fea_a[:B], fea_a[audio_gather_idx]], dim=0)
        fused, pack = self.forward_fusion(fea_v, fea_a, dup=2)
        head_in = fused[:B] if self.cls_matched_only else fused
        return self.forward_cls(head_in, image.shape[-2:]), fused, pack

    def forward(self, image, audio, eval_mode: bool = True, audio_gather_idx=None):
        """``eval_mode`` picks the batch construction, as in the JAX
        package: one audio clip per image, or the train path's 2B."""
        if eval_mode:
            return self.forward_inference(image, audio)
        return self.forward_train(image, audio, audio_gather_idx)
