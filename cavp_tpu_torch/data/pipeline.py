"""Host input pipeline: the prefetching loader and the batch assembly
(``cavp_tpu/data/pipeline.py``).

A thread pool decodes items ahead of the device step, in place of the
reference's ``torch.utils.data.DataLoader(num_workers=16, pin_memory)``,
and collation stacks them into dense
numpy batches: single-frame train batches (one random available frame a
video, or the one frame of a VPO item), padded [videos x 10 frames] eval
stacks with a validity mask in place of the reference's batch-1 per-frame
loop, and single-frame eval batches, every frame valid (VPO). Batches leave the
loader as numpy; the runner moves them to the card.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np


class DataLoader:
    """Thread-pool prefetching loader over an indexable dataset, in one
    process.

    ``shuffle`` draws the order of each epoch from ``random.Random(seed +
    epoch)`` (``set_epoch`` as the sampler's); ``drop_last`` drops a short
    last batch. The JAX package's loader also shards across processes;
    that comes with DDP (ROADMAP.md Queue 1 item 8). Items are made by
    ``num_workers`` threads: with more than one, the items' own ``random``
    draws interleave, so only ``num_workers=1`` gives the same batches run
    after run."""

    PREFETCH_BATCHES = 2

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 8, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """``sampler.set_epoch`` (main_avss_resize.py:214)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(indices)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        out_q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH_BATCHES)
        stop = threading.Event()

        def _put(item) -> bool:
            """A bounded put that gives up when the consumer abandoned the
            iterator: a plain blocking put would pin the producer thread
            and its prefetched batches."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, chunk))
                        if not _put(self.collate_fn(items)):
                            return
                _put(None)
            except BaseException as exc:
                # hand the failure to the consumer, which would otherwise
                # wait in out_q.get() for ever
                _put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


# ---------------------------------------------------------------------------
# Collation
# ---------------------------------------------------------------------------


def collate_stack(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        if isinstance(items[0][k], str):
            out[k] = [it[k] for it in items]
        else:
            out[k] = np.stack([it[k] for it in items])
    return out


def collate_train_videos(items, rng: Optional[random.Random] = None
                         ) -> Dict[str, np.ndarray]:
    """Train collation: one random available frame of each item
    (trainer_cavp_avss_image.py:157-167) in a single-frame batch. The
    choice is drawn from ``rng`` (default: the ``random`` module) also when
    one frame is available, as the JAX package's is."""
    rng = rng or random
    images, waves, pix, img_lab, names = [], [], [], [], []
    for it in items:
        choices = np.nonzero((it["frame_available"] + it["mask_available"]) == 2)[0]
        sel = int(rng.choice(list(choices)))
        images.append(it["image"][sel])
        waves.append(it["waveform"][sel][None])  # [1, L]
        pix.append(it["pix_label"][sel])
        img_lab.append(it["img_label"][sel])
        names.append(it["name"])
    return {"image": np.stack(images), "waveform": np.stack(waves),
            "pix_label": np.stack(pix), "img_label": np.stack(img_lab), "name": names}


def collate_train_frames(items) -> Dict[str, np.ndarray]:
    """Single-frame datasets (VPO): the items stacked, a frame axis of one
    squeezed where an item has it."""
    out = collate_stack(items)
    for k, ndim in (("image", 5), ("pix_label", 4), ("img_label", 3), ("waveform", 4)):
        if out[k].ndim == ndim:
            out[k] = out[k][:, 0]
    return out


def collate_eval_frames(items) -> Dict[str, np.ndarray]:
    """Single-frame eval collation (the VPO validation,
    trainer_cavp_vpo_mono.py:260-320): every frame valid."""
    out = collate_train_frames(items)
    out["valid"] = np.ones((out["image"].shape[0],), np.float32)
    return out


def collate_eval_videos(items) -> Dict[str, np.ndarray]:
    """Eval collation: [B, 10, ...] padded videos, validity from
    mask_available (in place of the reference's per-frame batch-1 loop)."""
    out = collate_stack(items)
    out["valid"] = out.pop("mask_available")
    out["waveform"] = out["waveform"][..., None, :]  # [B, T, 1, L]
    return out


def flatten_video_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """[B, T, ...] -> [B*T, ...] for the flat eval step."""
    flat = {}
    B, T = batch["image"].shape[:2]
    for k in ("image", "waveform", "pix_label"):
        v = batch[k]
        flat[k] = v.reshape((B * T,) + v.shape[2:])
    flat["valid"] = batch["valid"].reshape(B * T)
    return flat


def repack_valid_frames(batches):
    """Drop the invalid (padding) frames and re-emit dense flat batches of
    one size.

    AVSS videos are padded to 10 frame slots, but v1s/v1m videos hold 5
    real frames (``visual_dataset.py:82-95``): the flat eval step would run
    the whole forward on every slot and only weight the padding 0 in the
    metrics. Repacking keeps the same metric sums (the dropped frames
    weighed 0; the last partial batch is zero-padded with valid = 0) and
    skips the dead forwards. The size, the first batch's, stays fixed,
    also when the loader's last batch is short.
    """
    buf = None
    frame_batch = 0
    for batch in batches:
        if frame_batch == 0:
            frame_batch = batch["valid"].shape[0]
        keep = batch["valid"] > 0
        part = {k: v[keep] for k, v in batch.items()}
        buf = part if buf is None else {k: np.concatenate([buf[k], part[k]]) for k in part}
        while buf["valid"].shape[0] >= frame_batch:
            yield {k: v[:frame_batch] for k, v in buf.items()}
            buf = {k: v[frame_batch:] for k, v in buf.items()}
    if buf is not None and buf["valid"].shape[0]:
        n = buf["valid"].shape[0]
        yield {k: np.concatenate([v, np.zeros((frame_batch - n,) + v.shape[1:], v.dtype)])
               for k, v in buf.items()}
