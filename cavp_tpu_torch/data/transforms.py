"""Host-side visual transform, test mode (``cavp_tpu/data/transforms.py``).

The reference's ``dataset/avss/visual/visual_aug.py:8-89`` at test time:
an optional resize (bicubic frames, nearest masks, PIL's own resamplers),
then ToTensor + ImageNet normalize as float32 ``(x / 255 - mean) / std``
in that order, so the frames are bit-equal to the JAX package's PIL path.
Output layout: frames [H, W, 3] float32, masks [H, W] int32. The train
mode's random augmentation comes with ``run_training`` (ROADMAP.md Queue 1
item 3).
"""

from __future__ import annotations

import numpy as np

from cavp_tpu_torch.data.imageio import pil_image


class VisualAugmentation:
    """The reference class's call surface without ``setup``, which only
    train mode reads; ``mode="test"`` only."""

    def __init__(self, image_mean, image_std, image_width, image_height,
                 mode: str, resize_flag: bool = False):
        if mode == "train":
            raise NotImplementedError(
                "the train-mode augmentation is not ported yet (ROADMAP.md Queue 1 item 3)")
        self.image_size = (image_height, image_width)
        self.mean = np.asarray(image_mean, np.float32)
        self.std = np.asarray(image_std, np.float32)
        self.resize_flag = resize_flag

    def resize(self, image, label):
        Image = pil_image()
        h, w = self.image_size
        return (image.resize((w, h), Image.BICUBIC),
                label.resize((w, h), Image.NEAREST))

    def to_arrays(self, image, label):
        x = np.asarray(image, np.float32) / 255.0
        x = (x - self.mean) / self.std
        y = np.asarray(label).astype(np.int32)
        return x, y

    def test_aug(self, x, y):
        if self.resize_flag:
            x, y = self.resize(x, y)
        return self.to_arrays(x, y)

    __call__ = test_aug
