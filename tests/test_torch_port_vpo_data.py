"""The port's VPO data path against the JAX package's, draw for draw.

The tree is the port's ``make_synthetic_vpo`` (6 train and 2 test images a
setup, 48x48 test images, train images of mixed sizes, some smaller than
the 40x40 crop), read by both packages: the JAX package's CSV through
pandas, the port's through the ``csv`` module. Under the same
``random.seed`` both make the same Python ``random`` draws in the same
order (the flip, the COCO scale, the colour jitter's four factors and its
shuffle, the crop's top and left), so every item is bit-equal, for each of
the six setup x channel combinations, in train and test mode: the frame,
the remapped mask, the mono or panned (mixed, and for multi-source train
items flip-mirrored) waveform, the class label and the name. The JAX items
take their PIL path (the native decoder off), as in
``test_torch_port_train_data.py``. No model is built here: the module does
not take ``torch_port_common.release_after_module``.
"""

import random

import numpy as np
import pandas as pd
import pytest

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.data import audio_io as jax_audio_io
from cavp_tpu.data import pipeline as jax_pipeline
from cavp_tpu.data import vpo as jax_vpo
from cavp_tpu.data.transforms import ColorJitter as JaxColorJitter
from cavp_tpu.data.transforms import VisualAugmentation as JaxVisualAugmentation
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.data import audio_io, pipeline, vpo
from cavp_tpu_torch.data.imageio import open_rgb, pil_image
from cavp_tpu_torch.data.synthetic import make_synthetic_vpo
from cavp_tpu_torch.data.transforms import COCO_SCALES, ColorJitter, VisualAugmentation

SIZE, CROP, CLASSES = 48, 40, 6
SETUPS = ("vpo_ss", "vpo_ms", "vpo_msmi")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_vpo(str(tmp_path_factory.mktemp("vpo_tree")), num_train=6,
                              num_test=2, image_size=SIZE)


@pytest.fixture
def jax_pil_path(monkeypatch):
    """The JAX VPO items on their PIL path: the native decoders off."""
    for name in ("native_open_rgb", "native_open_index_mask"):
        monkeypatch.setattr(JaxVisualAugmentation, name, staticmethod(lambda *a, **k: None))


def _configs(root, setup, **kw):
    base = dict(root_dataset_dir=root, num_classes=CLASSES, image_width=CROP,
                image_height=CROP)
    base.update(kw)
    return get_config(setup).replace(**base), jax_get_config(setup).replace(**base)


def _same_item(got, ref, where):
    assert sorted(got) == sorted(ref), where
    for k, v in ref.items():
        if isinstance(v, str):
            assert got[k] == v, (where, k)
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, (where, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{where} {k}")


def test_the_tree_has_one_test_size_and_mixed_train_sizes(root):
    cfg, _ = _configs(root, "vpo_ss")
    raw = vpo.read_csv_rows(vpo.select_vpo_csv(cfg, stereo=False))
    assert {r["split"] for r in raw} == {"train", "val"}  # val is read as test
    for setup in SETUPS:
        c, _ = _configs(root, setup)
        rows = vpo.prepare_train_data(vpo.read_csv_rows(vpo.select_vpo_csv(c, True)), c,
                                      per_category_dir=setup == "vpo_ss")
        sizes = {split: {open_rgb(r["image_fp"]).size for r in rows if r["split"] == split}
                 for split in ("train", "test")}
        assert sizes["test"] == {(SIZE, SIZE)}, (setup, sizes)
        assert len(sizes["train"]) > 1 and min(min(s) for s in sizes["train"]) < CROP, sizes


@pytest.mark.parametrize("setup", SETUPS)
def test_prepare_train_data_matches_the_pandas_frame(root, setup):
    """The port's ``csv`` rows against the JAX package's pandas frame: the
    same rows in the same order, every cell equal as text, the derived
    paths equal (VPO-MSMI's rows with ``multi_instance`` 0 read from
    VPO-MS); also with ``replace_name``."""
    for replace_name in (False, True):
        cfg, jcfg = _configs(root, setup, replace_name=replace_name)
        path = vpo.select_vpo_csv(cfg, stereo=True)
        assert path == jax_vpo.select_vpo_csv(jcfg, stereo=True)
        per_category = setup == "vpo_ss"
        got = vpo.prepare_train_data(vpo.read_csv_rows(path), cfg, per_category)
        ref = jax_vpo.prepare_train_data(pd.read_csv(path), jcfg, per_category)
        assert len(got) == len(ref) and list(got[0]) == list(ref.columns)
        for g, (_, r) in zip(got, ref.iterrows()):
            assert g == {k: str(v) for k, v in r.items()}
        if setup == "vpo_msmi":
            moved = [g for g in got if g["multi_instance"] == "0"]
            assert moved and all("VPO-MS/" in g["image_fp"] and "VPO-MS/" in g["mask_fp"]
                                 for g in moved)
            assert all("VPO-MSMI/" in g["image_fp"] for g in got if g["multi_instance"] == "1")


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("setup", SETUPS)
def test_vpo_items_match_jax(root, jax_pil_path, setup, stereo):
    """Every train and test item, under three seeds, bit-equal, and the
    ``random`` state after each the same."""
    cfg, jcfg = _configs(root, setup)
    path = vpo.select_vpo_csv(cfg, stereo)
    multi = setup != "vpo_ss"
    rows, frame = vpo.read_csv_rows(path), pd.read_csv(path)
    flips = set()
    for mode in ("train", "test"):
        ds = vpo.VPODataset(cfg, mode, rows, stereo=stereo, multi_source=multi)
        jds = jax_vpo.VPODataset(jcfg, mode, frame, stereo=stereo, multi_source=multi)
        assert len(ds) == len(jds) == (6 if mode == "train" else 2)
        for seed in range(3):
            for i in range(len(ds)):
                random.seed(seed)
                got = ds[i]
                state = random.getstate()
                random.seed(seed)
                ref = jds[i]
                assert random.getstate() == state
                _same_item(got, ref, (setup, stereo, mode, seed, i))
                assert got["waveform"].shape == (2 if stereo else 1, 48000)
                if mode == "test":
                    assert got["image"].shape == (SIZE, SIZE, 3)
                else:
                    assert got["image"].shape == (CROP, CROP, 3)
                    random.seed(seed)
                    flips.add(random.random() > 0.5)
    assert flips == {False, True}  # both the mirrored and the plain panning ran


def test_color_jitter_and_the_coco_augmentation_match_jax():
    """The jitter alone and the COCO train augmentation with
    ``return_flip``, bit-equal under each of eight seeds; the AVS setups
    keep their scales and no jitter."""
    assert COCO_SCALES == [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]
    Image = pil_image()
    img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (20, 30, 3), np.uint8))
    mask = Image.fromarray(np.random.RandomState(1).randint(0, 4, (20, 30), np.uint8))
    for seed in range(8):
        random.seed(seed)
        got = np.asarray(ColorJitter()(img))
        random.seed(seed)
        np.testing.assert_array_equal(got, np.asarray(JaxColorJitter()(img)))
        kw = dict(image_mean=[0.485, 0.456, 0.406], image_std=[0.229, 0.224, 0.225],
                  image_width=16, image_height=24, mode="train", setup="vpo_ms",
                  return_flip=True)
        random.seed(seed)
        got = VisualAugmentation(**kw)(img, mask)
        random.seed(seed)
        ref = JaxVisualAugmentation(**kw)(img, mask)
        assert got[2] == ref[2]
        for g, r in zip(got[:2], ref[:2]):
            np.testing.assert_array_equal(g, r)
    for mode in ("train", "test"):
        aug = VisualAugmentation(kw["image_mean"], kw["image_std"], 16, 24, mode,
                                 setup="avss_binary")
        assert aug.color_jitter is None and len(aug(img, mask)) == 2


def test_pan_and_mix_match_jax():
    rng = np.random.RandomState(3)
    for wave in (rng.randn(2, 300).astype(np.float32), rng.randn(300).astype(np.float32)):
        for pos in (0.0, 0.3, 1.0):
            np.testing.assert_array_equal(audio_io.pan_stereo(wave, pos, 0.7),
                                          jax_audio_io.pan_stereo(wave, pos, 0.7))
    waves = [rng.randn(2, 50).astype(np.float32) for _ in range(3)]
    got = audio_io.mix_sources(waves)
    np.testing.assert_array_equal(got, jax_audio_io.mix_sources(waves))
    assert got.dtype == np.float32


@pytest.mark.parametrize("frame_axis", [False, True])
def test_frame_collations_match_jax(frame_axis):
    rng = np.random.RandomState(4)
    lead = (1,) if frame_axis else ()
    items = [{"image": rng.randn(*lead, 8, 8, 3).astype(np.float32),
              "waveform": rng.randn(*lead, 2, 30).astype(np.float32),
              "pix_label": rng.randint(0, 5, lead + (8, 8)).astype(np.int32),
              "img_label": rng.randint(0, 2, lead + (5,)).astype(np.int32),
              "name": str(i)} for i in range(3)]
    for fn, jfn in ((pipeline.collate_train_frames, jax_pipeline.collate_train_frames),
                    (pipeline.collate_eval_frames, jax_pipeline.collate_eval_frames)):
        got, ref = fn(items), jfn(items)
        _same_item({k: v for k, v in got.items() if k != "name"},
                   {k: v for k, v in ref.items() if k != "name"}, fn.__name__)
        assert got["name"] == ref["name"] == ["0", "1", "2"]
        assert got["image"].shape == (3, 8, 8, 3) and got["waveform"].shape == (3, 2, 30)
    assert np.array_equal(got["valid"], np.ones(3, np.float32))


def test_a_test_split_of_mixed_sizes_raises_in_both_packages(root, jax_pil_path, tmp_path):
    """A latent fault of the JAX package, mirrored: the VPO test items keep
    their size on disk (its ``VisualAugmentation`` gets no ``resize_flag``,
    ``cavp_tpu/data/vpo.py:85-88``) and the entry points validate
    ``batch_size`` of them a step, so a test split of mixed sizes cannot be
    stacked (``collate_stack``'s ``np.stack``). ROADMAP.md Queue 3."""
    import shutil

    tree = str(tmp_path / "mixed")
    shutil.copytree(root, tree)
    cfg, jcfg = _configs(tree, "vpo_ss")
    path = vpo.select_vpo_csv(cfg, stereo=False)
    rows = vpo.read_csv_rows(path)
    test = vpo.VPODataset(cfg, "test", rows, stereo=False)
    first = test.rows[0]["image_fp"]
    Image = pil_image()
    Image.fromarray(np.zeros((SIZE + 8, SIZE, 3), np.uint8)).save(first)
    mask = test.rows[0]["mask_fp"]
    Image.fromarray(np.zeros((SIZE + 8, SIZE), np.uint8)).save(mask)
    jtest = jax_vpo.VPODataset(jcfg, "test", pd.read_csv(path), stereo=False)
    for ds, collate in ((test, pipeline.collate_eval_frames),
                        (jtest, jax_pipeline.collate_eval_frames)):
        items = [ds[i] for i in range(len(ds))]
        assert {it["image"].shape for it in items} == {(SIZE + 8, SIZE, 3), (SIZE, SIZE, 3)}
        with pytest.raises(ValueError, match="same shape"):
            collate(items)
