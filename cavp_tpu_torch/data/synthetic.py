"""Synthetic data (``cavp_tpu/data/synthetic.py``): a miniature on-disk
AVSBench-Semantics tree, so the dataset, the loader and the evaluation
entry point run on real files, and in-memory batches with a setup's exact
shapes. The same seeds give the same pixels, waveforms and draws as the
JAX package's. :func:`make_synthetic_avsbench` writes mini S4 and MS3
trees for the J&F test entry point and :func:`make_synthetic_vpo` mini
VPO-SS, VPO-MS and VPO-MSMI trees for the VPO training entry points (the
JAX package has neither writer)."""

from __future__ import annotations

import os
import wave as wave_mod
from typing import Dict, Optional

import numpy as np

from cavp_tpu_torch.data.imageio import write_index_png, write_jpeg


def write_wav(path: str, data: np.ndarray, sr: int = 16000):
    """data: [channels, samples] float32 in [-1, 1] -> 16-bit PCM."""
    pcm = (np.clip(data, -1, 1) * 32767).astype("<i2")
    with wave_mod.open(path, "wb") as f:
        f.setnchannels(data.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.T.tobytes())


def make_synthetic_avss(root: str, num_videos: int = 4, image_size: int = 64,
                        num_classes: int = 8, seed: int = 0,
                        splits=("train", "test"), ambiguous: bool = False,
                        vary_pos: bool = False) -> str:
    """Write a mini ``avsbench_semantic`` tree and its ``metadata.csv``
    under ``root``; returns the tree's path. Video ``v`` of a split is in
    subset v1s, v1m, v2 in turn (5, 5 and 10 frames), shows one textured
    square of class ``1 + v % (num_classes - 1)`` at the center, and sounds
    a tone of that class.

    ``ambiguous``: classes 2k-1 and 2k share one tint while the tone stays
    per class, so only the audio tells the class. ``vary_pos``: the square
    sits at a random offset per video instead of the center, so a model
    must find it, not remember where it is."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "avsbench_semantic")
    rows = ["split,label,uid,a_obj,s_min,s_sec"]
    subsets = ["v1s", "v1m", "v2"]
    for split in splits:
        for v in range(num_videos):
            subset = subsets[v % 3]
            uid = f"{split}_vid{v}"
            vdir = os.path.join(base, subset, uid)
            os.makedirs(os.path.join(vdir, "frames"), exist_ok=True)
            os.makedirs(os.path.join(vdir, "labels_semantic"), exist_ok=True)
            n_frames = 10 if subset == "v2" else 5
            cls = 1 + v % (num_classes - 1)
            s = image_size // 4
            if vary_pos:
                y0 = int(rng.randint(0, image_size - 2 * s + 1))
                x0 = int(rng.randint(0, image_size - 2 * s + 1))
            else:
                y0 = x0 = s
            key = (cls + 1) // 2 if ambiguous else cls  # the tint's class
            tint = np.array([(key * 53) % 200 + 55, (key * 101) % 200 + 55,
                             (key * 179) % 200 + 55], np.uint8)
            for i in range(n_frames):
                img = rng.randint(0, 255, (image_size, image_size, 3), dtype=np.uint8)
                # the sounding object: a tinted textured square where the mask is
                region = img[y0:y0 + 2 * s, x0:x0 + 2 * s].astype(np.int32)
                img[y0:y0 + 2 * s, x0:x0 + 2 * s] = (region // 4 + tint).clip(0, 255).astype(
                    np.uint8)
                write_jpeg(os.path.join(vdir, "frames", f"{i}.jpg"), img)
            for i in range(n_frames):
                mask = np.zeros((image_size, image_size), np.uint8)
                mask[y0:y0 + 2 * s, x0:x0 + 2 * s] = cls
                write_index_png(os.path.join(vdir, "labels_semantic", f"{i}.png"), mask)
            t = np.linspace(0, 10, 160000, endpoint=False)
            tone = 0.3 * np.sin(2 * np.pi * (200 + 50 * cls) * t)
            write_wav(os.path.join(vdir, "audio.wav"), tone[None].astype(np.float32))
            rows.append(f"{split},{subset},{uid},obj{cls},0,0")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "metadata.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return base


def make_synthetic_avsbench(data_root: str, num_videos: int = 2, image_size: int = 64,
                            seed: int = 0, splits=("train", "test"),
                            category: str = "dog_barking") -> str:
    """Write mini S4 and MS3 trees (``data/avsbench.py``'s layout) under
    ``data_root``; returns it. Each video has five PNG frames with a
    textured square that moves by a few pixels from frame to frame, 0/255
    ``L`` PNG masks of that square (frames 1-5 in both splits), and a 10 s
    tone. S4 videos are of ``category``."""
    from cavp_tpu_torch.data.avsbench import ms3_paths, s4_paths
    from cavp_tpu_torch.data.imageio import write_png

    rng = np.random.RandomState(seed)
    s4, ms3 = s4_paths(data_root), ms3_paths(data_root)
    s4_rows, ms3_rows = ["name,split,category"], ["video_id,split"]
    s = image_size // 4
    t = np.linspace(0, 10, 160000, endpoint=False)

    def video(img_dir, mask_dir, wav_path, img_name, mask_name, v):
        for d in (img_dir, mask_dir, os.path.dirname(wav_path)):
            os.makedirs(d, exist_ok=True)
        for i in range(1, 6):
            img = rng.randint(0, 255, (image_size, image_size, 3), dtype=np.uint8)
            y0 = x0 = s + (i - 3) * max(s // 4, 1)
            mask = np.zeros((image_size, image_size), np.uint8)
            mask[y0:y0 + 2 * s, x0:x0 + 2 * s] = 255
            region = img[y0:y0 + 2 * s, x0:x0 + 2 * s].astype(np.int32)
            img[y0:y0 + 2 * s, x0:x0 + 2 * s] = (region // 4 + 150).clip(0, 255).astype(np.uint8)
            write_png(os.path.join(img_dir, img_name(i)), img)
            write_png(os.path.join(mask_dir, mask_name(i)), mask)
        tone = 0.3 * np.sin(2 * np.pi * (300 + 40 * v) * t)
        write_wav(wav_path, tone[None].astype(np.float32))

    for split in splits:
        for v in range(num_videos):
            name = f"{split}_s{v}"
            video(os.path.join(s4["dir_img"], split, category, name),
                  os.path.join(s4["dir_mask"], split, category, name),
                  os.path.join(s4["dir_wav"], split, category, name + ".wav"),
                  lambda i: f"{name}_{i}.png", lambda i: f"{name}_{i}.png", v)
            s4_rows.append(f"{name},{split},{category}")
            mid = f"{split}_m{v}"
            video(os.path.join(ms3["dir_img"], mid), os.path.join(ms3["dir_mask"], split, mid),
                  os.path.join(ms3["dir_wav"], split, mid + ".wav"),
                  lambda i: f"{mid}.mp4_{i}.png", lambda i: f"{mid}_{i}.png", v)
            ms3_rows.append(f"{mid},{split}")
    for paths, rows in ((s4, s4_rows), (ms3, ms3_rows)):
        os.makedirs(os.path.dirname(paths["anno_csv"]), exist_ok=True)
        with open(paths["anno_csv"], "w") as f:
            f.write("\n".join(rows) + "\n")
    return data_root


# (COCO id, name) of the VPO classes the VPO writer draws from, by VPO
# index 1-5 (config/class_list.py), so a model of 6 classes holds them all
VPO_CATEGORIES = ((5, "airplane"), (94, "baby"), (16, "bird"), (6, "bus"), (3, "car"))
VPO_CSV_COLUMNS = ("img_Id", "ann_Ids", "cateName", "cateId", "vgg_file", "audio_pos",
                   "split", "multi_instance")


def make_synthetic_vpo(root: str, num_train: int = 6, num_test: int = 2,
                       image_size: int = 64, seed: int = 0) -> str:
    """Write mini VPO trees under ``root`` (the setups' ``root_dataset_dir``);
    returns ``root``.

    - ``VPO/VPO-SS/``: one row an image, its category's COCO images under
      ``data/<cateName>/<img>.jpg`` and masks under
      ``mask/<cateName>/<img>_<ann>.png`` (8-bit, COCO ids);
    - ``VPO/VPO-MS/``: images of 1-3 sources, one row a source, flat
      ``data/`` and ``mask/`` trees (every row's mask holds every source);
    - ``VPO/VPO-MSMI/``: VPO-MS's rows with ``multi_instance`` 1 and 0 in
      turn; the images of the rows with 1 are written here (with other
      pixels), those with 0 are read from VPO-MS;
    - ``vggsound_bench/VGGSound/audios/<vgg_file>.wav``: 3.5 s, a tone a
      category (one of them stereo at 22.05 kHz, so the resampler and the
      channel mean run).

    Each tree has its ``vpo_*_data_{mono,stereo}.csv`` (the same rows).
    Test images are all ``image_size`` square (the VPO validation stacks
    them unresized); train images are of mixed sizes, some smaller than
    ``image_size``, so the pad of the train crop runs."""
    rng = np.random.RandomState(seed)
    categories = VPO_CATEGORIES
    audio_dir = os.path.join(root, "vggsound_bench", "VGGSound", "audios")
    os.makedirs(audio_dir, exist_ok=True)
    t = np.linspace(0, 3.5, 56000, endpoint=False)
    for i, (_, name) in enumerate(categories):
        tone = 0.3 * np.sin(2 * np.pi * (250 + 60 * i) * t)
        if i == 0:
            t2 = np.linspace(0, 3.5, int(3.5 * 22050), endpoint=False)
            wave = 0.3 * np.sin(2 * np.pi * 250 * t2)
            write_wav(os.path.join(audio_dir, f"vgg_{i}.wav"),
                      np.stack([wave, 0.5 * wave]).astype(np.float32), sr=22050)
        else:
            write_wav(os.path.join(audio_dir, f"vgg_{i}.wav"), tone[None].astype(np.float32))
    train_sizes = ((image_size * 3 // 4, image_size), (image_size, image_size * 5 // 4),
                   (image_size // 2, image_size * 3 // 4), (image_size, image_size))

    def picture(h, w, objects):
        """A noise frame with a tinted box per (category index, COCO id),
        and the 8-bit mask of the boxes' COCO ids."""
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w), np.uint8)
        for k, (cat, cid) in enumerate(objects):
            y0 = int(rng.randint(0, max(h // 2, 1)))
            x0 = int(rng.randint(0, max(w // 2, 1)))
            box = (slice(y0, y0 + h // 3 + 1), slice(x0, x0 + w // 3 + 1))
            tint = np.array([(cat * 53) % 200 + 55, (cat * 101) % 200 + 55,
                             (cat * 179) % 200 + 55], np.int32)
            img[box] = (img[box].astype(np.int32) // 4 + tint).clip(0, 255).astype(np.uint8)
            mask[box] = cid
        return img, mask

    def write_csv(tree, rows):
        for suffix in ("mono", "stereo"):
            name = os.path.basename(tree.rstrip("/")).lower().replace("-", "_")
            with open(os.path.join(tree, f"{name}_data_{suffix}.csv"), "w") as f:
                f.write(",".join(VPO_CSV_COLUMNS) + "\n")
                for r in rows:
                    f.write(",".join(str(r[c]) for c in VPO_CSV_COLUMNS) + "\n")

    vpo = os.path.join(root, "VPO")
    splits = ["train"] * num_train + ["val"] * num_test
    # VPO-SS: one source an image, per-category directories
    tree, rows = os.path.join(vpo, "VPO-SS"), []
    for n, split in enumerate(splits):
        cat = n % len(categories)
        cid, name = categories[cat]
        h, w = train_sizes[n % len(train_sizes)] if split == "train" else (image_size,) * 2
        img, mask = picture(h, w, [(cat, cid)])
        img_id, ann = 1000 + n, 5000 + n
        for sub, data, fn in (("data", img, f"{img_id:012d}.jpg"),
                              ("mask", mask, f"{img_id:012d}_{ann:012d}.png")):
            os.makedirs(os.path.join(tree, sub, name), exist_ok=True)
            path = os.path.join(tree, sub, name, fn)
            write_jpeg(path, data) if sub == "data" else write_index_png(path, data)
        rows.append(dict(img_Id=img_id, ann_Ids=ann, cateName=name, cateId=cid,
                         vgg_file=f"vgg_{cat}", audio_pos=round(float(rng.rand()), 3),
                         split=split, multi_instance=1))
    write_csv(tree, rows)
    # VPO-MS and VPO-MSMI: 1-3 sources an image, flat directories
    ms, msmi = os.path.join(vpo, "VPO-MS"), os.path.join(vpo, "VPO-MSMI")
    for tr in (ms, msmi):
        for sub in ("data", "mask"):
            os.makedirs(os.path.join(tr, sub), exist_ok=True)
    ms_rows, msmi_rows = [], []
    for n, split in enumerate(splits):
        k = 1 + n % 3
        cats = [int(c) for c in rng.choice(len(categories), k, replace=False)]
        objects = [(c, categories[c][0]) for c in cats]
        h, w = train_sizes[n % len(train_sizes)] if split == "train" else (image_size,) * 2
        img_id, multi_instance = 2000 + n, n % 2
        anns = [6000 + 10 * n + j for j in range(k)]
        trees = (ms, msmi) if multi_instance else (ms,)
        for tr in trees:
            img, mask = picture(h, w, objects)
            write_jpeg(os.path.join(tr, "data", f"{img_id:012d}.jpg"), img)
            for ann in anns:
                write_index_png(os.path.join(tr, "mask", f"{img_id:012d}_{ann:012d}.png"), mask)
        for c, ann in zip(cats, anns):
            row = dict(img_Id=img_id, ann_Ids=ann, cateName=categories[c][1],
                       cateId=categories[c][0], vgg_file=f"vgg_{c}",
                       audio_pos=round(float(rng.rand()), 3), split=split, multi_instance=1)
            ms_rows.append(row)
            msmi_rows.append(dict(row, multi_instance=multi_instance))
    write_csv(ms, ms_rows)
    write_csv(msmi, msmi_rows)
    return root


def synthetic_train_batch(config, batch_size: Optional[int] = None, seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """Random train batch: image [B,H,W,3], waveform [B,Ca,L], pix_label
    [B,H,W], img_label [B,classes] multi-hot (background plus one source
    class per sample); the same draws as the JAX package's for the same
    seed."""
    rng = np.random.RandomState(seed)
    B = batch_size or config.batch_size
    H, W = config.image_height, config.image_width
    C = config.num_classes
    batch = {
        "image": rng.randn(B, H, W, 3).astype(np.float32),
        "waveform": (rng.rand(B, config.in_plane, config.audio_samples)
                     .astype(np.float32) - 0.5) * 0.2,
        "pix_label": rng.randint(0, C, (B, H, W)).astype(np.int32),
        "img_label": np.zeros((B, C), np.int32),
    }
    batch["img_label"][:, 0] = 1
    for i in range(B):
        batch["img_label"][i, 1 + i % (C - 1)] = 1
    return batch


def synthetic_eval_batch(config, num_frames: int, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Flat eval batch ([N frames]) with a validity mask; the same draws
    as the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    H, W = config.image_height, config.image_width
    N = num_frames
    return {
        "image": rng.randn(N, H, W, 3).astype(np.float32),
        "waveform": (rng.rand(N, config.in_plane, config.audio_samples)
                     .astype(np.float32) - 0.5) * 0.2,
        "pix_label": rng.randint(0, config.num_classes, (N, H, W)).astype(np.int32),
        "valid": np.ones((N,), np.float32),
    }
