"""Host-side visual augmentation (``cavp_tpu/data/transforms.py``).

The reference's ``dataset/avss/visual/visual_aug.py:8-89``:

- train: a random horizontal flip, a random scale from ``AVS_SCALES``,
  then either a resize to the configured size (``resize_flag``) or a pad
  (mean colour for frames, 255 for masks) and a random crop;
- test: an optional resize;
- then ToTensor + ImageNet normalize as float32 ``(x / 255 - mean) / std``
  in that order.

Frames are resized bicubic, masks nearest, with PIL's own resamplers, and
the random draws come from Python's ``random`` module in the JAX
package's order (flip, scale, crop top, crop left), so under the same
``random.seed`` the arrays are bit-equal to the JAX package's PIL path.
Output layout: frames [H, W, 3] float32, masks [H, W] int32. The COCO and
VPO setups' ``ColorJitter`` is not ported (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import random

import numpy as np

from cavp_tpu_torch.data.imageio import pil_image

AVS_SCALES = [0.5, 0.75, 1.0]
AVS_SETUPS = ("avs", "avss", "avss_binary")


class VisualAugmentation:
    """The reference class's call surface: ``mode`` is ``"train"`` or
    ``"test"``; ``setup`` picks the train-mode scales (only the AVS
    setups, whose list has no colour jitter, are ported)."""

    def __init__(self, image_mean, image_std, image_width, image_height,
                 mode: str, resize_flag: bool = False, setup: str = "avss"):
        if mode == "train" and setup not in AVS_SETUPS:
            raise NotImplementedError(
                f"the {setup!r} train augmentation (COCO scales and ColorJitter) is not "
                "ported yet (ROADMAP.md Queue 1 item 5)")
        self.mode = mode
        self.image_size = (image_height, image_width)
        self.mean = np.asarray(image_mean, np.float32)
        self.std = np.asarray(image_std, np.float32)
        self.resize_flag = resize_flag
        self.scale_list = list(AVS_SCALES)

    def resize(self, image, label):
        Image = pil_image()
        h, w = self.image_size
        return (image.resize((w, h), Image.BICUBIC),
                label.resize((w, h), Image.NEAREST))

    def random_scales(self, image, label):
        Image = pil_image()
        w, h = image.size
        s = random.choice(self.scale_list)
        w, h = int(w * s), int(h * s)
        return image.resize((w, h), Image.BICUBIC), label.resize((w, h), Image.NEAREST)

    def random_crop_with_padding(self, image, label):
        Image = pil_image()
        w, h = image.size
        th, tw = self.image_size
        if min(h, w) < min(self.image_size):
            pad_w, pad_h = max(tw - w, 0), max(th - h, 0)
            fill = tuple(int(round(m * 255)) for m in self.mean)
            new_img = Image.new("RGB", (w + pad_w, h + pad_h), fill)
            new_img.paste(image, (0, 0))
            new_lab = Image.new(label.mode, (w + pad_w, h + pad_h), 255)
            new_lab.paste(label, (0, 0))
            image, label = new_img, new_lab
            w, h = image.size
        top = random.randint(0, max(h - th, 0))
        left = random.randint(0, max(w - tw, 0))
        box = (left, top, left + tw, top + th)
        return image.crop(box), label.crop(box)

    def to_arrays(self, image, label):
        x = np.asarray(image, np.float32) / 255.0
        x = (x - self.mean) / self.std
        y = np.asarray(label).astype(np.int32)
        return x, y

    def train_aug(self, x, y):
        if random.random() > 0.5:
            Image = pil_image()
            x = x.transpose(Image.FLIP_LEFT_RIGHT)
            y = y.transpose(Image.FLIP_LEFT_RIGHT)
        x, y = self.random_scales(x, y)
        if self.resize_flag:
            x, y = self.resize(x, y)
        else:
            x, y = self.random_crop_with_padding(x, y)
        return self.to_arrays(x, y)

    def test_aug(self, x, y):
        if self.resize_flag:
            x, y = self.resize(x, y)
        return self.to_arrays(x, y)

    def __call__(self, x, y):
        return self.train_aug(x, y) if self.mode == "train" else self.test_aug(x, y)
