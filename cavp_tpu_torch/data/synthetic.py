"""Synthetic data (``cavp_tpu/data/synthetic.py``): a miniature on-disk
AVSBench-Semantics tree, so the dataset, the loader and the evaluation
entry point run on real files, and in-memory batches with a setup's exact
shapes. The same seeds give the same pixels, waveforms and draws as the
JAX package's. :func:`make_synthetic_avsbench` writes mini S4 and MS3
trees for the J&F test entry point (the JAX package has no such writer)."""

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
