"""VPO datasets: COCO images and masks paired with VGGSound clips
(``cavp_tpu/data/vpo.py``).

The reference's four ``dataset/vpo_{mono,stereo}/{single,multi}_source``
trees as one class:

- the rows of a VPO CSV (``img_Id``, ``ann_Ids``, ``cateName``,
  ``cateId``, ``vgg_file``, ``audio_pos``, ``split``, optionally
  ``multi_instance``), read with the ``csv`` module; :func:`prepare_train_data`
  derives each row's audio, image and mask paths (:func:`process_coco_fn`:
  ``data/<cateName>/<img>.jpg`` and ``mask/<cateName>/<img>_<ann>.png``, or
  flat for the multi-source trees; VPO-MSMI rows with ``multi_instance ==
  0`` read from VPO-MS) and maps ``val`` to ``test``;
- a mono item is the mean of the clip's channels; a stereo one pans it by
  ``audio_pos``;
- a multi-source item groups the rows of one ``img_Id`` and mixes their
  panned (or mono) clips; its train flip mirrors each position
  (``1 - pos``), which only the multi-source reference does;
- the mask's COCO ids become VPO indices, every one read from the
  original mask (the reference remaps in place, so a write can alias a
  later id; not replicated, as in the JAX package);
- the class label: for single-source items the rows' categories and the
  background bit; for multi-source items the classes the remapped,
  augmented mask still holds.

Frames and masks are decoded with PIL (``data/imageio.py``) and augmented
by ``data/transforms.VisualAugmentation`` (COCO scales and the colour
jitter in train mode); the random draws come from Python's ``random`` in
the JAX package's order, so seeded items are bit-equal to its PIL path.
As in the JAX package the augmentation gets no ``resize_flag``: test
items keep their size on disk.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence

import numpy as np

from cavp_tpu_torch.data.audio_io import crop_audio, load_wav, mix_sources, pan_stereo, resample
from cavp_tpu_torch.data.imageio import open_mask, open_rgb
from cavp_tpu_torch.data.pipeline import collate_train_frames
from cavp_tpu_torch.data.transforms import VisualAugmentation


def read_csv_rows(path: str) -> List[Dict[str, str]]:
    """The rows of a VPO CSV as dicts of strings, in file order."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def process_coco_fn(row, root_name: str, ext: str = "jpg", mask: bool = False,
                    setup: str = None, per_category_dir: bool = True) -> str:
    """A row's image (or, with ``mask``, mask) path under ``root_name``."""
    img_n = str(row["img_Id"]).zfill(12)
    mask_n = str(row["ann_Ids"]).zfill(12)
    name = f"{img_n}_{mask_n}.{ext}" if mask else f"{img_n}.{ext}"
    if per_category_dir:
        fn = os.path.join(root_name, row["cateName"], name)
    else:
        fn = os.path.join(root_name, name)
    if setup == "vpo_msmi" and float(row.get("multi_instance", 1)) == 0:
        fn = fn.replace("VPO-MSMI", "VPO-MS")
    return fn


_PERSON = {"male": "person", "female": "person", "baby": "person"}


def prepare_train_data(rows: Sequence[Dict[str, str]], config,
                       per_category_dir: bool = True) -> List[Dict[str, str]]:
    """Copies of ``rows`` with ``audio_fp``, ``image_fp`` and ``mask_fp``
    and ``val`` read as ``test`` (``visual_dataset.prepare_train_data:21-46``).
    ``config.replace_name`` first folds male, female and baby into person
    (the cells equal to one of them, and the pseudo-ids 92-94 of
    ``cateId`` into 1)."""
    out = []
    for row in rows:
        r = dict(row)
        if config.replace_name:
            r = {k: _PERSON.get(v, v) for k, v in r.items()}
            if "cateId" in r and r["cateId"] in ("92", "93", "94"):
                r["cateId"] = "1"
        r["audio_fp"] = os.path.join(config.vgg_data_path, "audios", r["vgg_file"] + ".wav")
        r["image_fp"] = process_coco_fn(r, config.coco_img_root, "jpg", setup=config.setup,
                                        per_category_dir=per_category_dir)
        r["mask_fp"] = process_coco_fn(r, config.coco_mask_root, "png", mask=True,
                                       setup=config.setup, per_category_dir=per_category_dir)
        if r["split"] == "val":
            r["split"] = "test"
        out.append(r)
    return out


def _load_crop(path: str, audio_len: float) -> np.ndarray:
    wave, sr = load_wav(path)
    return crop_audio(resample(wave, sr), audio_len)


class VPODataset:
    """One split of a VPO CSV: mono or stereo, single- or multi-source
    (``multi_source`` groups the rows by ``img_Id``)."""

    def __init__(self, config, mode: str, rows: Sequence[Dict[str, str]], stereo: bool = True,
                 multi_source: bool = False, per_category_dir: bool = None):
        self.config = config
        self.mode = mode
        self.stereo = stereo
        self.multi_source = multi_source
        if per_category_dir is None:
            per_category_dir = not multi_source
        split = "train" if mode == "train" else "test"
        self.rows = [r for r in prepare_train_data(rows, config, per_category_dir)
                     if r["split"] == split]
        self.transform = VisualAugmentation(
            image_mean=config.image_mean, image_std=config.image_std,
            image_width=config.image_width, image_height=config.image_height,
            mode=mode, setup=config.setup, return_flip=True)
        self.index_table = config.index_table
        self.class_dict = config.class_dict
        self.num_classes = config.num_classes
        if multi_source:
            groups: Dict[str, List[Dict[str, str]]] = {}
            for r in self.rows:  # in the order of each id's first row
                groups.setdefault(r["img_Id"], []).append(r)
            self.groups = list(groups.values())
        else:
            self.groups = [[r] for r in self.rows]

    def __len__(self):
        return len(self.groups)

    def _remap_mask(self, label: np.ndarray) -> np.ndarray:
        """COCO id -> VPO index (visual_dataset.py:124-135), every id read
        from ``label``, the original mask."""
        out = label.copy()
        for cid in np.unique(label):
            if cid in (0, 255):
                continue
            name = self.class_dict.get(str(int(cid)))
            if name is None:
                continue
            out[label == cid] = self.index_table.index(name)
        return out

    def _category_onehot(self, cate_names: str) -> np.ndarray:
        onehot = np.zeros((self.num_classes,), np.int32)
        onehot[0] = 1
        for name in str(cate_names).split(","):
            if name in self.index_table:
                onehot[self.index_table.index(name)] = 1
        return onehot

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rows = self.groups[idx]
        first = rows[0]
        x, y, flip = self.transform(open_rgb(first["image_fp"]), open_mask(first["mask_fp"]))
        y = self._remap_mask(y.astype(np.int32))

        waves = []
        for r in rows:
            w = _load_crop(r["audio_fp"], self.config.audio_len)
            pos = float(r.get("audio_pos", 0.5))
            # only the multi-source reference mirrors the panning with the
            # flip (multi_source audio_dataset.py:58)
            if flip and self.mode == "train" and self.multi_source:
                pos = 1.0 - pos
            waves.append(pan_stereo(w, pos) if self.stereo else np.mean(w, axis=0, keepdims=True))
        waveform = mix_sources(waves) if len(waves) > 1 else waves[0]

        onehot = np.zeros((self.num_classes,), np.int32)
        if self.multi_source:
            # the classes the remapped, augmented mask still holds
            # (multi_source visual_dataset.py:148-150): a crop can drop a
            # source, and the background bit is set only where it survives
            u = np.unique(y)
            onehot[u[(u != 255) & (u < self.num_classes)]] = 1
        else:
            # the rows' categories and the background bit
            # (single_source visual_dataset.py:77-80,138-141)
            onehot[0] = 1
            for r in rows:
                onehot |= self._category_onehot(r["cateName"])
        return {"image": x.astype(np.float32), "waveform": waveform.astype(np.float32),
                "pix_label": y.astype(np.int32), "img_label": onehot,
                "name": str(first["img_Id"])}


def select_vpo_csv(config, stereo: bool) -> str:
    """The setup's CSV (main_vpo_{mono,stereo}.py:139-157)."""
    suffix = "stereo" if stereo else "mono"
    name = {"vpo_ss": f"vpo_ss_data_{suffix}.csv", "vpo_ms": f"vpo_ms_data_{suffix}.csv",
            "vpo_msmi": f"vpo_msmi_data_{suffix}.csv"}[config.setup]
    return os.path.join(config.vpo_data_path, name)


def make_datasets(config, stereo: bool):
    """(train, test, train collation) of ``main_vpo_{mono,stereo}``: the
    setup's CSV, multi-source for VPO-MS and VPO-MSMI."""
    rows = read_csv_rows(select_vpo_csv(config, stereo))
    multi = config.setup in ("vpo_ms", "vpo_msmi")
    return (VPODataset(config, "train", rows, stereo=stereo, multi_source=multi),
            VPODataset(config, "test", rows, stereo=stereo, multi_source=multi),
            collate_train_frames)
