"""AVSBench-Object datasets: S4 (single source) and MS3 (multiple sources)
(``cavp_tpu/data/avsbench.py``).

The reference's ``dataset/avsbench_s4.py:38-152`` and
``dataset/avsbench_ms.py:37-185``:

- S4: five frames ``<video>_<i>.png`` a video under ``<split>/<category>/``;
  the train split has mask 1 only, the test split masks 1-5;
- MS3: the test split as five-frame videos; the train split exploded into
  one row per frame (x5), then repeated (x2), each row with its frame's
  1 s of audio;
- masks are opened with PIL's ``convert("1")`` (binary, {0, 1});
- the 10 s centre crop of the audio is cut into five 2 s windows for the
  five frames of a test video (the reference J&F test's ``view(B, 5, 1,
  -1)``: frame i hears seconds [2i, 2i + 2)), padded to the AVSS layout's
  ten slots with zero rows.

Video items are padded to ten frame slots with zero images and zero masks,
with the availability flags of the AVSS layout, so the eval collation
serves both benchmarks. The frames keep their size on disk (the reference
builds these transforms without ``resize_flag``). The metadata is read
with the ``csv`` module; S4's rows are read by position (name first,
category third), as the reference reads them.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from cavp_tpu_torch.data.audio_io import load_audio
from cavp_tpu_torch.data.imageio import open_binary_mask, open_rgb, pil_image
from cavp_tpu_torch.data.transforms import VisualAugmentation

# the S4 categories after background: the class index of a video's
# one-hot label when the model has more than two classes
INDEX_TABLE_AVS = [
    "background", "ambulance_siren", "baby_laughter", "cap_gun_shooting", "cat_meowing",
    "chainsawing_trees", "coyote_howling", "dog_barking", "driving_buses", "female_singing",
    "helicopter", "horse_clip-clop", "lawn_mowing", "lions_roaring", "male_speech",
    "mynah_bird_singing", "playing_acoustic_guitar", "playing_glockenspiel", "playing_piano",
    "playing_tabla", "playing_ukulele", "playing_violin", "race_car",
    "typing_on_computer_keyboard",
]

FRAMES = 5  # annotated frames of an AVSBench-Object video
SLOTS = 10  # frame slots of the AVSS layout


def s4_paths(data_root: str) -> Dict[str, str]:
    """config/avsbench/config_avsbench_s4.py."""
    base = os.path.join(data_root, "avsbench_data", "Single-source")
    return {
        "anno_csv": os.path.join(base, "s4_meta_data.csv"),
        "dir_img": os.path.join(base, "s4_data", "visual_frames"),
        "dir_mask": os.path.join(base, "s4_data", "gt_masks"),
        "dir_wav": os.path.join(base, "s4_data", "audio_wav"),
    }


def ms3_paths(data_root: str) -> Dict[str, str]:
    base = os.path.join(data_root, "avsbench_data", "Multi-sources")
    return {
        "anno_csv": os.path.join(base, "ms3_meta_data.csv"),
        "dir_img": os.path.join(base, "ms3_data", "visual_frames"),
        "dir_mask": os.path.join(base, "ms3_data", "gt_masks"),
        "dir_wav": os.path.join(base, "ms3_data", "audio_wav"),
    }


def _rows(csv_path: str, split: str) -> List[List[str]]:
    """The metadata rows of ``split`` (its ``split`` column), as lists of
    strings in the file's column order."""
    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        col = header.index("split")
        return [row for row in reader if row and row[col] == split]


def _pad_slots(x: np.ndarray) -> np.ndarray:
    """[5, ...] -> [10, ...] with zero slots."""
    return np.concatenate([x, np.zeros((SLOTS - x.shape[0],) + x.shape[1:], x.dtype)])


def _test_windows(wav: str) -> np.ndarray:
    """[10, 32000]: five 2 s windows of the 10 s crop, then five zero rows."""
    waveform = load_audio(wav, 10.0).reshape(FRAMES, -1)
    return np.concatenate([waveform, np.zeros_like(waveform)]).astype(np.float32)


def _video_arrays(transform, img_paths, mask_paths, augment: bool):
    """Decode and transform a video's frames and masks (masks padded with
    zero masks to the frame count): (image [5, H, W, 3] float32, label
    [5, H, W] int32 in {0, 1})."""
    images = [open_rgb(p) for p in img_paths]
    labels = [open_binary_mask(p) for p in mask_paths]
    Image = pil_image()
    while len(labels) < len(images):
        labels.append(Image.fromarray(np.zeros_like(np.asarray(labels[-1]))))
    step = transform if augment else transform.test_aug
    pack = [step(im, lb) for im, lb in zip(images, labels)]
    image = np.stack([p[0] for p in pack])
    label = np.clip(np.stack([p[1] for p in pack]).astype(np.int32), 0, 1)
    return image, label


class S4Dataset:
    """``avsbench_s4.S4Dataset``: five-frame videos, padded to ten slots."""

    def __init__(self, config, split: str = "train"):
        self.config = config
        self.split = split
        self.mask_num = 1 if split == "train" else FRAMES
        self.paths = s4_paths(config.data_root)
        self.rows = _rows(self.paths["anno_csv"], split)
        self.transform = VisualAugmentation(
            image_mean=config.image_mean, image_std=config.image_std,
            image_width=config.image_width, image_height=config.image_height,
            mode=split, setup=config.setup)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.rows[index]
        video, category = row[0], row[2]
        img_base = os.path.join(self.paths["dir_img"], self.split, category, video)
        mask_base = os.path.join(self.paths["dir_mask"], self.split, category, video)
        img_paths = [os.path.join(img_base, f"{video}_{i}.png") for i in range(1, FRAMES + 1)]
        mask_paths = [os.path.join(mask_base, f"{video}_{i}.png")
                      for i in range(1, self.mask_num + 1)]
        image, label = _video_arrays(self.transform, img_paths, mask_paths,
                                     augment=self.split == "train")
        waveform = _test_windows(os.path.join(self.paths["dir_wav"], self.split, category,
                                              video + ".wav"))
        if self.config.num_classes <= 2:
            class_label = np.tile(np.array([[0, 1]], np.int32), (SLOTS, 1))
        else:
            class_label = np.zeros((SLOTS, len(INDEX_TABLE_AVS)), np.int32)
            class_label[:, INDEX_TABLE_AVS.index(category)] = 1
        mask_avail = [1] + [0] * 9 if self.split == "train" else [1] * 5 + [0] * 5
        return {
            "image": _pad_slots(image.astype(np.float32)),
            "waveform": waveform,
            "pix_label": _pad_slots(label),
            "img_label": class_label,
            "name": video,
            "frame_available": np.array([1] * 5 + [0] * 5, np.float32),
            "mask_available": np.array(mask_avail, np.float32),
        }


class MS3Dataset:
    """``avsbench_ms.MS3Dataset``: the train split one frame a row (x5
    frames, x2 repeats) with the frame's 1 s of audio; the test split
    five-frame videos padded to ten slots."""

    def __init__(self, config, split: str = "train"):
        self.config = config
        self.split = split
        self.paths = ms3_paths(config.data_root)
        with open(self.paths["anno_csv"], newline="") as f:
            self.videos = [r["video_id"] for r in csv.DictReader(f) if r["split"] == split]
        if split == "train":
            rows = [(v, i) for v in self.videos for i in range(1, FRAMES + 1)]
            self.train_rows = rows * 2  # avsbench_ms.py:86-87
        self.transform = VisualAugmentation(
            image_mean=config.image_mean, image_std=config.image_std,
            image_width=config.image_width, image_height=config.image_height,
            mode=split, setup=config.setup)

    def __len__(self):
        return len(self.train_rows) if self.split == "train" else len(self.videos)

    def _wav(self, video: str) -> str:
        return os.path.join(self.paths["dir_wav"], self.split, video + ".wav")

    def _frame(self, video: str, i: int) -> str:
        return os.path.join(self.paths["dir_img"], video, f"{video}.mp4_{i}.png")

    def _mask(self, video: str, i: int) -> str:
        return os.path.join(self.paths["dir_mask"], self.split, video, f"{video}_{i}.png")

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.split == "train":
            video, img_id = self.train_rows[index]
            x, y = self.transform(open_rgb(self._frame(video, img_id)),
                                  open_binary_mask(self._mask(video, img_id)))
            y = np.clip(y.astype(np.int32), 0, 1)
            waveform = load_audio(self._wav(video), 10.0).reshape(SLOTS, -1)
            # F.one_hot((mask.sum() != 0).long(), 2), avsbench_ms.py:135-136:
            # [0, 1] for a mask with an object, [1, 0] for an empty one
            class_label = np.zeros((1, self.config.num_classes), np.int32)
            class_label[0, 1 if y.sum() > 0 else 0] = 1
            return {
                "image": x[None].astype(np.float32),
                "waveform": waveform[img_id - 1:img_id].astype(np.float32),
                "pix_label": y[None],
                "img_label": class_label,
                "name": video,
            }

        video = self.videos[index]
        image, label = _video_arrays(
            self.transform, [self._frame(video, i) for i in range(1, FRAMES + 1)],
            [self._mask(video, i) for i in range(1, FRAMES + 1)], augment=False)
        avail = np.array([1] * 5 + [0] * 5, np.float32)
        return {
            "image": _pad_slots(image.astype(np.float32)),
            "waveform": _test_windows(self._wav(video)),
            "pix_label": _pad_slots(label),
            "img_label": np.tile(np.array([[0, 1]], np.int32), (SLOTS, 1)),
            "name": video,
            "frame_available": avail,
            "mask_available": avail.copy(),
        }
