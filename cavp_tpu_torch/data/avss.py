"""AVSBench-Semantics dataset (``cavp_tpu/data/avss.py``).

The reference's ``dataset/avss/avss_datasets.py`` with its
``visual/visual_dataset.py`` and ``audio/audio_dataset.py``: the rows of
``metadata.csv`` (uid, label = v1s / v1m / v2, split), each video's
``frames/%d.jpg`` and ``labels_semantic/%d.png`` padded to 10 slots, the
per-subset availability flags, one-hot class labels from each mask's
values, the binary collapse for a resized single-subset split, and the 10 s
of audio cut into ten 1 s windows. Items are dicts of numpy arrays for the
loader: a test item holds the video's ten slots (frames [10, H, W, 3]); a
train item holds one available frame, chosen with ``random.choice``
*before* anything is decoded, augmented, with its 1 s audio window
(frames [1, H, W, 3]), as the JAX package's train items do.

Under ``avss_binary`` the model has 2 classes but the one-hot class labels
stay 71 wide, as the reference's ``VisualDataset`` always makes them (its
data config's 71 classes): they decide the train step's semantic pairing.
The masks collapse to binary under ``resize_flag`` for that setup as for
a single-subset split.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List

import numpy as np

from cavp_tpu_torch.data.audio_io import load_audio
from cavp_tpu_torch.data.imageio import open_mask, open_rgb, pil_image
from cavp_tpu_torch.data.transforms import VisualAugmentation


def get_v2_palette(num_cls: int = 71) -> List[int]:
    """The AVSBench-v2 color palette (visual_dataset.get_v2_pallete:14-39)."""
    palette = [0] * (num_cls * 3)
    for j in range(num_cls):
        lab = j
        i = 0
        while lab > 0:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette


def availability_flags(subset: str, mode: str):
    """(frame, mask) availability of the 10 slots (visual_dataset.__getflag:82-95)."""
    if subset == "v1s":
        frame = np.array([1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.float32)
        if mode == "train":
            mask = np.array([1, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)
        else:
            mask = frame.copy()
    elif subset == "v1m":
        frame = np.array([1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.float32)
        mask = frame.copy()
    else:  # v2
        frame = np.ones(10, np.float32)
        mask = np.ones(10, np.float32)
    return frame, mask


class AVSSDataset:
    """The joined visual and audio dataset over ``metadata.csv``."""

    MASK_NUM = 10
    AUDIO_SECONDS = 10.0

    def __init__(self, config, mode: str):
        self.config = config
        self.mode = mode
        self.dir_base = os.path.join(config.root_dataset_dir, "avsbench_semantic")
        with open(os.path.join(self.dir_base, "metadata.csv"), newline="") as f:
            rows = [r for r in csv.DictReader(f) if r["split"] == mode]
        if config.avsbench_split != "all":
            rows = [r for r in rows if r["label"] == config.avsbench_split]
        self.rows = rows
        self.num_classes = 71 if config.setup == "avss_binary" else config.num_classes
        self.transform = VisualAugmentation(
            image_mean=config.image_mean, image_std=config.image_std,
            image_width=config.image_width, image_height=config.image_height,
            mode=mode, resize_flag=config.resize_flag, setup=config.setup)

    def __len__(self):
        return len(self.rows)

    def _one_hot(self, label: np.ndarray) -> np.ndarray:
        """[n, classes] int32: the classes each mask holds (255 and values
        past the last class left out)."""
        class_label = np.zeros((label.shape[0], self.num_classes), np.int32)
        for i in range(label.shape[0]):
            u = np.unique(label[i][label[i] != 255])
            u = u[u < self.num_classes]
            class_label[i, u] = 1
        return class_label

    def _collapse(self, label: np.ndarray) -> np.ndarray:
        """The binary collapse of a resized single-subset split or of the
        resized ``avss_binary`` setup (visual_dataset.py:160-165)."""
        if self.config.resize_flag and (self.config.avsbench_split != "all"
                                        or self.config.setup == "avss_binary"):
            return np.where((label != 255) & (label != 0), 1, label)
        return label

    def _train_item(self, row, vdir: str, n_img: int, n_mask: int, frame_avail,
                    mask_avail) -> Dict[str, np.ndarray]:
        """One random available frame, decoded and augmented alone, with
        its audio window; availability [1], so ``collate_train_videos``
        takes it as it is. A frame or mask that is flagged available but
        missing on disk is a zero image of the last one's size."""
        avail = np.nonzero((frame_avail > 0) & (mask_avail > 0))[0]
        sel = int(random.choice(list(avail)))
        Image = pil_image()
        if sel < n_img:
            img = open_rgb(os.path.join(vdir, "frames", f"{sel}.jpg"))
        else:
            ref = open_rgb(os.path.join(vdir, "frames", f"{n_img - 1}.jpg"))
            img = Image.fromarray(np.zeros_like(np.asarray(ref)))
        if sel < n_mask:
            lab = open_mask(os.path.join(vdir, "labels_semantic", f"{sel}.png"))
        else:
            ref = open_mask(os.path.join(vdir, "labels_semantic", f"{n_mask - 1}.png"))
            lab = Image.fromarray(np.zeros_like(np.asarray(ref)))
        image, label = self.transform(img, lab)
        label = label[None].astype(np.int32)
        class_label = self._one_hot(label)
        waveform = load_audio(os.path.join(vdir, "audio.wav"), self.AUDIO_SECONDS)
        one = np.ones(1, np.float32)
        return {
            "image": image[None].astype(np.float32),
            "waveform": waveform.reshape(self.MASK_NUM, -1)[sel:sel + 1].astype(np.float32),
            "pix_label": self._collapse(label),
            "img_label": class_label,
            "name": row["uid"],
            "frame_available": one,
            "mask_available": one.copy(),
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        row = self.rows[idx]
        subset = row["label"]
        frame_avail, mask_avail = availability_flags(subset, self.mode)

        vdir = os.path.join(self.dir_base, subset, row["uid"])
        fn_img = os.path.join(vdir, "frames")
        fn_label = os.path.join(vdir, "labels_semantic")
        n_img = sum(f.endswith(".jpg") for f in os.listdir(fn_img))
        n_mask = sum(f.endswith(".png") for f in os.listdir(fn_label))
        if self.mode == "train":
            return self._train_item(row, vdir, n_img, n_mask, frame_avail, mask_avail)
        images = [open_rgb(os.path.join(fn_img, f"{i}.jpg")) for i in range(n_img)]
        labels = [open_mask(os.path.join(fn_label, f"{i}.png")) for i in range(n_mask)]
        # a video with fewer masks than frames (or the reverse) pairs its
        # extra frames with zero images, as the reference pads
        Image = pil_image()
        n = max(n_img, n_mask)
        images += [Image.fromarray(np.zeros_like(np.asarray(images[-1])))] * (n - n_img)
        labels += [Image.fromarray(np.zeros_like(np.asarray(labels[-1])))] * (n - n_mask)
        pack = [self.transform(im, lb) for im, lb in zip(images, labels)]
        image = np.stack([p[0] for p in pack])  # [n, H, W, 3]
        label = np.stack([p[1] for p in pack])  # [n, H, W]
        if n < self.MASK_NUM:
            # the reference pads with zero images, which normalize to
            # -mean/std, and with zero masks
            fill = ((0.0 - self.transform.mean) / self.transform.std).astype(np.float32)
            pad = self.MASK_NUM - n
            image = np.concatenate([image, np.broadcast_to(fill, (pad,) + image.shape[1:])])
            label = np.concatenate([label, np.zeros((pad,) + label.shape[1:], label.dtype)])

        class_label = self._one_hot(label)
        label = self._collapse(label)

        waveform = load_audio(os.path.join(vdir, "audio.wav"), self.AUDIO_SECONDS)
        waveform = waveform.reshape(self.MASK_NUM, -1)  # ten 1 s windows

        return {
            "image": image.astype(np.float32),
            "waveform": waveform.astype(np.float32),
            "pix_label": label.astype(np.int32),
            "img_label": class_label,
            "name": row["uid"],
            "frame_available": frame_avail,
            "mask_available": mask_avail,
        }
