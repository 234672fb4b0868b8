"""Host-side visual augmentation (``cavp_tpu/data/transforms.py``).

The reference's ``dataset/avss/visual/visual_aug.py:8-89``:

- train: a random horizontal flip, a random scale (``AVS_SCALES`` for the
  AVS setups; ``COCO_SCALES`` and then a :class:`ColorJitter` for the
  VPO setups, the reference's ``dataset/vpo_*/*/visual/visual_aug.py``),
  then either a resize to the configured size (``resize_flag``) or a pad
  (mean colour for frames, 255 for masks) and a random crop;
- test: an optional resize;
- then ToTensor + ImageNet normalize as float32 ``(x / 255 - mean) / std``
  in that order.

Frames are resized bicubic, masks nearest, with PIL's own resamplers, and
the random draws come from Python's ``random`` module in the JAX
package's order (flip, scale, the jitter's four factors and its shuffle,
crop top, crop left), so under the same ``random.seed`` the arrays are
bit-equal to the JAX package's PIL path. Output layout: frames [H, W, 3]
float32, masks [H, W] int32. ``return_flip`` adds whether the train
augmentation flipped (the stereo multi-source datasets mirror their
panning by it).
"""

from __future__ import annotations

import random

import numpy as np

from cavp_tpu_torch.data.imageio import pil_image

AVS_SCALES = [0.5, 0.75, 1.0]
COCO_SCALES = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]
AVS_SETUPS = ("avs", "avss", "avss_binary")


class ColorJitter:
    """torchvision's ``ColorJitter(brightness=.5, contrast=.5,
    saturation=.5, hue=.25)`` on PIL images: four factors drawn in that
    order, then the four operations applied in a shuffled order."""

    brightness = contrast = saturation = 0.5
    hue = 0.25

    def __call__(self, img):
        from PIL import ImageEnhance

        b = random.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        c = random.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        s = random.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
        h = random.uniform(-self.hue, self.hue)
        ops = [
            lambda im: ImageEnhance.Brightness(im).enhance(b),
            lambda im: ImageEnhance.Contrast(im).enhance(c),
            lambda im: ImageEnhance.Color(im).enhance(s),
            lambda im: _shift_hue(im, h),
        ]
        random.shuffle(ops)
        for op in ops:
            img = op(img)
        return img


def _shift_hue(img, hue_factor: float):
    """The hue channel of ``img`` shifted by ``hue_factor`` of a turn, in
    PIL's 8-bit HSV."""
    if abs(hue_factor) < 1e-8:
        return img
    hsv = np.asarray(img.convert("HSV"), dtype=np.uint8).copy()
    shift = np.uint8(int(hue_factor * 255)) if hue_factor >= 0 else np.uint8(
        256 + int(hue_factor * 255))
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + shift) % 256
    return pil_image().fromarray(hsv, "HSV").convert("RGB")


class VisualAugmentation:
    """The reference class's call surface: ``mode`` is ``"train"`` or
    ``"test"``; ``setup`` picks the train-mode scales and whether a
    colour jitter follows them (the setups other than the AVS ones)."""

    def __init__(self, image_mean, image_std, image_width, image_height,
                 mode: str, resize_flag: bool = False, setup: str = "avss",
                 return_flip: bool = False):
        self.mode = mode
        self.image_size = (image_height, image_width)
        self.mean = np.asarray(image_mean, np.float32)
        self.std = np.asarray(image_std, np.float32)
        self.resize_flag = resize_flag
        self.return_flip = return_flip
        if setup in AVS_SETUPS:
            self.scale_list, self.color_jitter = list(AVS_SCALES), None
        else:
            self.scale_list, self.color_jitter = list(COCO_SCALES), ColorJitter()

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
        flip = random.random() > 0.5
        if flip:
            Image = pil_image()
            x = x.transpose(Image.FLIP_LEFT_RIGHT)
            y = y.transpose(Image.FLIP_LEFT_RIGHT)
        x, y = self.random_scales(x, y)
        if self.color_jitter is not None:
            x = self.color_jitter(x)
        if self.resize_flag:
            x, y = self.resize(x, y)
        else:
            x, y = self.random_crop_with_padding(x, y)
        x, y = self.to_arrays(x, y)
        return (x, y, flip) if self.return_flip else (x, y)

    def test_aug(self, x, y):
        if self.resize_flag:
            x, y = self.resize(x, y)
        x, y = self.to_arrays(x, y)
        return (x, y, False) if self.return_flip else (x, y)

    def __call__(self, x, y):
        return self.train_aug(x, y) if self.mode == "train" else self.test_aug(x, y)
