"""The port's training data path against the JAX package's, draw for draw.

Under the same ``random.seed`` both packages make the same Python
``random`` draws in the same order (the item's frame choice, the flip, the
scale, the crop's top and left, then the collation's choice), so the
train augmentation, the train items, the shuffled loader's batches and
the collation are bit-equal, and the ``random`` state
after them is the same. The items are compared with the JAX package's
PIL path (its native decoder off, as ``test_torch_port_data.py``'s item tests do; both decode
with PIL). The loader runs one worker: with several, the threads'
draws interleave, in either package.

The tree is the JAX package's ``make_synthetic_avss`` at 48x48, 6
classes, 4 train videos and 1 test video; one train video (v2, ten
available slots) keeps only its first frame and its first five masks, so
most of its draws land on the zero-image fallback of a frame or mask that
is flagged available but missing. No model is built here: the module
does not take ``torch_port_common.release_after_module``.
"""

import os
import random

import numpy as np
import pytest
import torch

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.data import avss as jax_avss
from cavp_tpu.data import pipeline as jax_pipeline
from cavp_tpu.data.synthetic import make_synthetic_avss as jax_make_synthetic_avss
from cavp_tpu.data.transforms import VisualAugmentation as JaxVisualAugmentation
from cavp_tpu.engine.optim import current_lrs as jax_current_lrs
from cavp_tpu.engine.optim import make_optimizer as jax_make_optimizer
from cavp_tpu.engine.runner import _global_batch as jax_global_batch
from cavp_tpu_torch.config.setups import get_config
from cavp_tpu_torch.data import avss, pipeline
from cavp_tpu_torch.data.imageio import open_mask, open_rgb
from cavp_tpu_torch.data.transforms import VisualAugmentation
from cavp_tpu_torch.engine import runner
from cavp_tpu_torch.engine.optim import current_lrs, make_optimizer

SIZE, CLASSES, VIDEOS = 48, 6, 4
SEEDS = range(12)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's writer's tree; returns the dataset root."""
    root = tmp_path_factory.mktemp("avss_train_tree")
    base = jax_make_synthetic_avss(str(root), num_videos=VIDEOS, image_size=SIZE,
                                   num_classes=CLASSES, splits=("train", "test"))
    vdir = os.path.join(base, "v2", "train_vid2")
    for i in range(1, 10):
        os.remove(os.path.join(vdir, "frames", f"{i}.jpg"))
    for i in range(5, 10):
        os.remove(os.path.join(vdir, "labels_semantic", f"{i}.png"))
    return str(root)


@pytest.fixture
def jax_pil_path(monkeypatch):
    """The JAX train items on their PIL path: the native pair decoder off."""
    monkeypatch.setattr(JaxVisualAugmentation, "native_open_pair",
                        staticmethod(lambda *a, **k: None))


def _configs(root, **kw):
    base = dict(image_width=SIZE, image_height=SIZE, num_classes=CLASSES,
                root_dataset_dir=root, num_workers=1)
    base.update(kw)
    return get_config("avss").replace(**base), jax_get_config("avss").replace(**base)


def _same(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], (str, list)):
            assert got[k] == ref[k], k
            continue
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _drawn(fn, seed):
    """fn()'s result and the next draw of ``random`` after it, from ``seed``."""
    random.seed(seed)
    out = fn()
    return out, random.random()


@pytest.mark.parametrize("resize_flag,hw", [(False, (40, 32)), (False, (48, 48)),
                                            (True, (40, 32))],
                         ids=["pad-and-crop", "crop-at-size", "resize"])
def test_train_aug_bit_equal_to_jax(tree, resize_flag, hw):
    """Every seed's flip, scale and crop (the pad's mean colour and 255
    where a scale falls below the size): the same arrays and draws."""
    frame = os.path.join(tree, "avsbench_semantic", "v2", "train_vid2", "frames", "0.jpg")
    mask = os.path.join(tree, "avsbench_semantic", "v2", "train_vid2",
                        "labels_semantic", "0.png")
    kw = dict(image_mean=[0.485, 0.456, 0.406], image_std=[0.229, 0.224, 0.225],
              image_width=hw[1], image_height=hw[0], mode="train", resize_flag=resize_flag)
    aug, jaug = VisualAugmentation(**kw), JaxVisualAugmentation(setup="avss", **kw)
    padded = 0
    for seed in SEEDS:
        (x, y), after = _drawn(lambda: aug(open_rgb(frame), open_mask(mask)), seed)
        (jx, jy), jafter = _drawn(lambda: jaug(open_rgb(frame), open_mask(mask)), seed)
        assert after == jafter, seed
        assert x.shape == (*hw, 3) and x.dtype == np.float32 and y.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        padded += bool((y == 255).any())
    # padded where the scale fell below the size, never under resize_flag
    assert padded == 0 if resize_flag else 0 < padded < len(SEEDS)


@pytest.mark.parametrize("kw", [{}, dict(resize_flag=True, image_width=32, image_height=40),
                                dict(resize_flag=True, avsbench_split="v2")],
                         ids=["pad-and-crop", "resized", "v2-binary"])
def test_train_items_bit_equal_to_the_jax_pil_path(tree, jax_pil_path, kw):
    """Every item of the split under every seed: the chosen frame's image,
    mask (the binary collapse of a resized single-subset split), one-hot
    label and 1 s audio window, availability [1], the name; the missing
    frame and masks of train_vid2 come out as zero images."""
    cfg, jcfg = _configs(tree, **kw)
    ds, jds = avss.AVSSDataset(cfg, "train"), jax_avss.AVSSDataset(jcfg, "train")
    assert len(ds) == len(jds) == (1 if "avsbench_split" in kw else VIDEOS)
    fallback = 0
    for seed in SEEDS:
        for i in range(len(ds)):
            got, after = _drawn(lambda: ds[i], seed)
            ref, jafter = _drawn(lambda: jds[i], seed)
            assert after == jafter, (seed, i)
            _same(got, ref)
            h, w = (40, 32) if "image_width" in kw else (SIZE, SIZE)
            assert got["image"].shape == (1, h, w, 3) and got["waveform"].shape == (1, 16000)
            if got["name"] == "train_vid2":
                fallback += set(np.unique(got["pix_label"])) <= {0, 255}
    assert fallback > 0  # the zero-mask fallback was drawn


def test_loader_batches_bit_equal_to_jax(tree, jax_pil_path):
    """Shuffled, last batch dropped, two epochs through ``set_epoch``, one
    worker, the train collation: the same batches in the same order."""
    cfg, jcfg = _configs(tree)
    kw = dict(shuffle=True, drop_last=True, num_workers=1, seed=5)
    loader = pipeline.DataLoader(avss.AVSSDataset(cfg, "train"), 3,
                                 pipeline.collate_train_videos, **kw)
    jloader = jax_pipeline.DataLoader(jax_avss.AVSSDataset(jcfg, "train"), 3,
                                      jax_pipeline.collate_train_videos, **kw)
    assert len(loader) == len(jloader) == 1
    names = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, after = _drawn(lambda: list(loader), epoch)
        ref, jafter = _drawn(lambda: list(jloader), epoch)
        assert after == jafter and len(got) == len(ref) == 1
        _same(got[0], ref[0])
        assert got[0]["image"].shape == (3, SIZE, SIZE, 3)
        assert got[0]["waveform"].shape == (3, 1, 16000)
        names.append(got[0]["name"])
    assert names[0] != names[1]  # each epoch its own order


class _Indices:
    """A dataset whose item is its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("n", [10, 9, 3, 2, 0])
@pytest.mark.parametrize("drop_last", [True, False], ids=["drop_last", "keep_last"])
def test_loader_length_equals_jax(n, drop_last):
    kw = dict(drop_last=drop_last)
    assert len(pipeline.DataLoader(_Indices(n), 3, None, **kw)) == \
        len(jax_pipeline.DataLoader(_Indices(n), 3, None, **kw))


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (5, 0), (5, 3)])
def test_loader_order_equals_jax(seed, epoch):
    """The indices of each batch of a shuffled epoch, without the items'
    own draws: ``random.Random(seed + epoch)``'s order, as the JAX
    package's one-process shard."""
    kw = dict(shuffle=True, drop_last=False, num_workers=1, seed=seed)
    loader = pipeline.DataLoader(_Indices(11), 4, list, **kw)
    jloader = jax_pipeline.DataLoader(_Indices(11), 4, list, **kw)
    loader.set_epoch(epoch)
    jloader.set_epoch(epoch)
    got = list(loader)
    assert got == list(jloader)
    assert sorted(sum(got, [])) == list(range(11)) and [len(b) for b in got] == [4, 4, 3]


def test_collate_train_videos_equals_jax():
    """Items of ten slots with their own availability: one draw an item,
    also where a single slot is available."""
    rng = np.random.RandomState(0)
    items = []
    for v, n in enumerate((10, 5, 1)):
        avail = np.zeros(10, np.float32)
        avail[:n] = 1
        items.append({"image": rng.randn(10, 4, 4, 3).astype(np.float32),
                      "waveform": rng.randn(10, 16).astype(np.float32),
                      "pix_label": rng.randint(0, 3, (10, 4, 4)).astype(np.int32),
                      "img_label": rng.randint(0, 2, (10, 3)).astype(np.int32),
                      "name": f"v{v}", "frame_available": avail, "mask_available": avail})
    for seed in SEEDS:
        got = pipeline.collate_train_videos(items, random.Random(seed))
        ref = jax_pipeline.collate_train_videos(items, random.Random(seed))
        _same(got, ref)
    r, jr = random.Random(3), random.Random(3)
    pipeline.collate_train_videos(items[2:], r)
    jax_pipeline.collate_train_videos(items[2:], jr)
    assert r.random() == jr.random() != random.Random(3).random()


@pytest.mark.parametrize("n_train,gpus,max_steps", [(48, 1, None), (50, 2, None), (9, 1, None),
                                                     (200, 1, 3)])
def test_steps_per_epoch_and_every_steps_lrs_match_jax(n_train, gpus, max_steps):
    """The steps an epoch (``len // global batch``, at least one, capped)
    and the four displayed lrs at every step of a 3-epoch run."""
    cfg, jcfg = _configs("", batch_size=4, gpus=gpus, epochs=3, lr=0.02 * gpus,
                         warm_up_epoch=1)
    assert runner._global_batch(cfg) == jax_global_batch(jcfg) == 4 * gpus
    spe = runner.steps_per_epoch(cfg, n_train, max_steps)
    jspe = max(n_train // jax_global_batch(jcfg), 1)
    assert spe == (min(jspe, max_steps) if max_steps else jspe)
    stand_in = torch.nn.Module()
    stand_in.backbone = torch.nn.Linear(2, 2)
    _, schedule = make_optimizer(stand_in, cfg, spe)
    _, jschedule = jax_make_optimizer(jcfg, spe)
    # eager, as the JAX package's loop reads them (under jit XLA divides
    # by the warmup length as a product with its reciprocal). The JAX
    # package's are float32. The warmup's are equal; the poly decay's
    # ``power`` is numpy's in the port and XLA's in the JAX package, which
    # is not correctly rounded: they differ by an ulp at some steps, which
    # the x10 of the segmentation head's lr may round to two; within twice
    # float32's epsilon, relative
    off = 0
    for c in range(1, 3 * spe + 1):
        got, ref = current_lrs(schedule, cfg, c), jax_current_lrs(jschedule, jcfg, c)
        assert sorted(got) == sorted(ref)
        for k in got:
            g, r = np.float32(got[k]), np.asarray(ref[k])
            if c <= spe:  # the warmup epoch
                assert g == r, (c, k)
            assert abs(float(g) - float(r)) <= 2 * np.finfo(np.float32).eps * float(r), (c, k)
            off += bool(g != r)
    assert off <= 4 * 2 * spe


def test_color_jitter_setups_raise(tree):
    """The COCO and VPO setups' train augmentation (their scales and
    ColorJitter) is not ported; their test mode and the AVS setups' train
    mode are."""
    cfg, _ = _configs(tree)
    kw = dict(image_mean=cfg.image_mean, image_std=cfg.image_std, image_width=SIZE,
              image_height=SIZE)
    for setup in ("coco", "vpo_ms", "vpo_ss"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            VisualAugmentation(mode="train", setup=setup, **kw)
        VisualAugmentation(mode="test", setup=setup, **kw)
    for setup in ("avs", "avss", "avss_binary"):
        VisualAugmentation(mode="train", setup=setup, **kw)
