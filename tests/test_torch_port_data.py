"""The port's data path against the JAX package's, on the same files.

The config and its flags, the wav reader, the test-mode transform, the
AVSBench-Semantics dataset, the loader with its eval collation and dense
repacking, and the synthetic tree writer. The tree is the JAX package's
``make_synthetic_avss`` at 48x48, 6 classes, 3 test videos (one each of
v1s, v1m and v2), and all of it is cheap: no model is built here, so
the module does not take ``torch_port_common.release_after_module``, the
heap release that costs seconds a worker when the run is under load.

Tolerances. Items and batches are bit-equal to the JAX package's PIL
path (both decode with PIL and normalize in float32 in the same order).
The writers' files are byte-equal.
"""

import os
import sys
import wave

import numpy as np
import pytest
import torch

from cavp_tpu.config import load_args_and_config as jax_load_args_and_config
from cavp_tpu.data import audio_io as jax_audio_io
from cavp_tpu.data import avss as jax_avss
from cavp_tpu.data import pipeline as jax_pipeline
from cavp_tpu.data.synthetic import make_synthetic_avss as jax_make_synthetic_avss
from cavp_tpu.data.synthetic import write_wav as jax_write_wav
from cavp_tpu.data.transforms import VisualAugmentation as JaxVisualAugmentation
from cavp_tpu_torch.config import load_args_and_config
from cavp_tpu_torch.config.setups import Config, get_config
from cavp_tpu_torch.data import audio_io, avss, imageio, pipeline
from cavp_tpu_torch.data.synthetic import make_synthetic_avss, write_wav
from cavp_tpu_torch.data.transforms import VisualAugmentation
from cavp_tpu_torch.engine.checkpoint import load_model_variables

SIZE, CLASSES, VIDEOS = 48, 6, 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's writer's test split; returns the dataset root."""
    root = tmp_path_factory.mktemp("avss_tree")
    jax_make_synthetic_avss(str(root), num_videos=VIDEOS, image_size=SIZE,
                            num_classes=CLASSES, splits=("test",))
    return str(root)


@pytest.fixture
def jax_pil_path(monkeypatch):
    """The JAX dataset on its PIL path: its native eval decoder off, as
    it is on a machine where ``cavp_tpu/native`` does not build."""
    monkeypatch.setattr(JaxVisualAugmentation, "native_eval_batch",
                        lambda self, *a, **k: None)


def _configs(root, **kw):
    base = dict(image_width=SIZE, image_height=SIZE, num_classes=CLASSES,
                root_dataset_dir=root, num_workers=2)
    base.update(kw)
    from cavp_tpu.config import get_config as jax_get_config
    return get_config("avss").replace(**base), jax_get_config("avss").replace(**base)


def _assert_same(got, ref, exact=True):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], (str, list)):
            assert got[k] == ref[k], k
            continue
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        if exact or k != "image":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# config and flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--setup", "avss"],
    ["--setup", "avss", "--resize_flag", "--num_workers", "4", "--visual_backbone", "18",
     "--compute_dtype", "float32", "--root_dataset_dir", "/data", "--ckpt_path", "a.pth",
     "--use_pallas_fusion", "--use_pallas_argmax", "--use_pallas_mel", "--use_pallas_layer1",
     "--avsbench_split", "v1m", "--gpus", "2", "--lr", "0.01", "--batch_size", "4",
     "--no_audio_dedup", "--wandb_mode", "disabled"],
], ids=["defaults", "every-flag"])
def test_flags_give_the_jax_package_config(argv):
    """Every field the port's Config has equals the JAX config's for the
    same command line."""
    got = load_args_and_config(argv)
    ref = jax_load_args_and_config(argv)
    fields = [f for f in Config.__dataclass_fields__ if f != "steps_per_epoch"]
    assert "resize_flag" in fields and "eval_dense_pack" in fields
    for f in fields:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.data_path == ref.data_path


@pytest.mark.parametrize("argv,exc,match", [
    (["--setup", "avss_binary", "--data_root", "/objects", "--avsbench_split", "v1s",
      "--resize_flag"], None, None),
    (["--setup", "vpo_ms"], None, None),
    (["--setup", "avss", "--use_baseline"], None, None),
    (["--setup", "avss", "--wandb_mode", "online"], NotImplementedError, "Queue 1 item 3"),
    (["--setup", "coco"], ValueError, "Unknown setup"),  # the parser's default setup
    (["--setup", "avss", "--use_tfdata"], SystemExit, None),  # a TPU-only flag
], ids=["avss_binary", "vpo", "baseline", "wandb", "unknown", "tpu-only"])
def test_setups_and_flags_not_ported_raise(argv, exc, match):
    """The setups and flags the port does not have raise; those it has
    since ROADMAP.md Queue 1 items 4 and 5 (``avss_binary``,
    ``--use_baseline``, the VPO setups) give the JAX package's config,
    field for field."""
    if exc is None:
        got, ref = load_args_and_config(argv), jax_load_args_and_config(argv)
        for f in (f for f in Config.__dataclass_fields__ if f != "steps_per_epoch"):
            assert getattr(got, f) == getattr(ref, f), f
        assert got.data_path == ref.data_path
        return
    with pytest.raises(exc, match=match):
        load_args_and_config(argv)


# ---------------------------------------------------------------------------
# audio, images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr,channels,seconds,audio_len", [
    (16000, 1, 10.0, 10.0), (44100, 2, 3.0, 1.0), (8000, 1, 0.3, 1.0)],
    ids=["16k", "44k-stereo", "short-wraps"])
def test_load_audio_matches_jax(tmp_path, sr, channels, seconds, audio_len):
    """Read, resample, crop (a short clip wraps from its end and tiles) and
    mono mean: bit-equal; the two wav writers write the same bytes."""
    rng = np.random.RandomState(sr)
    data = (rng.rand(channels, int(sr * seconds)) - 0.5).astype(np.float32)
    path, jpath = str(tmp_path / "a.wav"), str(tmp_path / "j.wav")
    write_wav(path, data, sr)
    jax_write_wav(jpath, data, sr)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got = audio_io.load_audio(path, audio_len)
    ref = jax_audio_io.load_audio(path, audio_len)
    assert got.shape == (1, int(16000 * audio_len)) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_decoder_is_pil_and_raises_without_it(monkeypatch, tree):
    assert imageio.decoder_name().startswith("PIL ")
    frame = os.path.join(tree, "avsbench_semantic", "v2", "test_vid2", "frames", "0.jpg")
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(imageio.open_rgb(frame)),
                                  np.asarray(Image.open(frame).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)  # "import PIL" now fails
    for call in (imageio.decoder_name, lambda: imageio.open_rgb(frame)):
        with pytest.raises(RuntimeError, match="PIL"):
            call()


def test_train_mode_is_not_ported(tree):
    """Train mode is ported for every setup: the COCO and VPO setups'
    augmentation takes the COCO scales and the colour jitter (held against
    the JAX package's in ``test_torch_port_vpo_data.py``), the AVS setups'
    neither (held in ``test_torch_port_train_data.py``)."""
    cfg, _ = _configs(tree)
    aug = VisualAugmentation(cfg.image_mean, cfg.image_std, SIZE, SIZE, "train", setup="vpo_ms")
    ref = JaxVisualAugmentation(cfg.image_mean, cfg.image_std, SIZE, SIZE, "train", "vpo_ms")
    assert aug.scale_list == ref.scale_list and aug.color_jitter is not None
    assert len(avss.AVSSDataset(cfg, "train")) == 0  # the tree has no train split


def test_palette_and_availability_flags_match_jax():
    assert avss.get_v2_palette(71) == jax_avss.get_v2_palette(71)
    for subset in ("v1s", "v1m", "v2"):
        for mode in ("train", "test"):
            for got, ref in zip(avss.availability_flags(subset, mode),
                                jax_avss.availability_flags(subset, mode)):
                np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# dataset items and loader batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(resize_flag=True, image_width=32, image_height=40),
                                dict(resize_flag=True, avsbench_split="v1m")],
                         ids=["source-size", "resized", "v1m-binary"])
def test_items_bit_equal_to_the_jax_pil_path(tree, jax_pil_path, kw):
    """Every key of every item: frames (resized bicubic under
    ``resize_flag``, padded slots at -mean/std), masks (nearest; the binary
    collapse for a split other than "all"), one-hot labels, the ten audio
    windows, the availability flags and the name."""
    cfg, jcfg = _configs(tree, **kw)
    ds, jds = avss.AVSSDataset(cfg, "test"), jax_avss.AVSSDataset(jcfg, "test")
    assert len(ds) == len(jds) == (1 if "avsbench_split" in kw else VIDEOS)
    for i in range(len(ds)):
        _assert_same(ds[i], jds[i])
    item = ds[0]
    h, w = (40, 32) if "image_width" in kw else (SIZE, SIZE)
    assert item["image"].shape == (10, h, w, 3) and item["waveform"].shape == (10, 16000)


def test_loader_batches_and_the_dense_repack_bit_equal_to_jax(tree, jax_pil_path):
    """Batches of 2 videos (the last one short), flattened, then repacked
    without the padding frames: the same arrays in the same order."""
    cfg, jcfg = _configs(tree)
    loader = pipeline.DataLoader(avss.AVSSDataset(cfg, "test"), 2,
                                 pipeline.collate_eval_videos, num_workers=2)
    jloader = jax_pipeline.DataLoader(jax_avss.AVSSDataset(jcfg, "test"), 2,
                                      jax_pipeline.collate_eval_videos, num_workers=2,
                                      pad_shards=False)
    batches, jbatches = list(loader), list(jloader)
    assert len(batches) == len(jbatches) == 2
    for got, ref in zip(batches, jbatches):
        _assert_same(got, ref)
    assert batches[0]["waveform"].shape == (2, 10, 1, 16000)

    def stream(bs, flatten, repack):
        flat = []
        for b in bs:
            b = {k: v for k, v in b.items() if k not in ("name", "img_label", "frame_available")}
            flat.append(flatten(b))
        return list(repack(flat))

    got = stream(batches, pipeline.flatten_video_batch, pipeline.repack_valid_frames)
    ref = stream(jbatches, jax_pipeline.flatten_video_batch, jax_pipeline.repack_valid_frames)
    assert len(got) == len(ref) == 1  # 20 valid frames of 30 slots, in one batch of 20
    for g, r in zip(got, ref):
        _assert_same(g, r)
    assert got[0]["valid"].sum() == 20


def test_loader_hands_on_a_worker_failure():
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 2:
                raise OSError("unreadable frame")
            return {"x": np.zeros(2)}

    loader = pipeline.DataLoader(Broken(), 2, pipeline.collate_stack, num_workers=2)
    it = iter(loader)
    assert next(it)["x"].shape == (2, 2)
    with pytest.raises(OSError, match="unreadable"):
        next(it)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("options", [{}, dict(ambiguous=True), dict(vary_pos=True),
                                     dict(ambiguous=True, vary_pos=True)],
                         ids=["plain", "ambiguous", "vary_pos", "both"])
def test_synthetic_tree_is_byte_equal_to_the_jax_writer(tmp_path, options):
    """Both splits, every file: the same names and the same bytes (both
    encode with PIL, so the JPEG frames decode to the same pixels), with
    and without the training-fixture options (classes that share a tint,
    squares at random offsets)."""
    kw = dict(num_videos=VIDEOS, image_size=SIZE, num_classes=CLASSES, seed=3, **options)
    base = make_synthetic_avss(str(tmp_path / "port"), **kw)
    jbase = jax_make_synthetic_avss(str(tmp_path / "jax"), **kw)

    def files(b):
        return sorted(os.path.relpath(os.path.join(d, f), b)
                      for d, _, fs in os.walk(b) for f in fs)

    names = files(base)
    assert names == files(jbase)
    assert len(names) == 1 + 2 * (2 * (5 + 5 + 1) + (10 + 10 + 1))
    for name in names:
        with open(os.path.join(base, name), "rb") as f, open(os.path.join(jbase, name), "rb") as g:
            assert f.read() == g.read(), name
    with wave.open(os.path.join(base, "v2", "test_vid2", "audio.wav")) as w:
        assert (w.getframerate(), w.getnframes()) == (16000, 160000)


# ---------------------------------------------------------------------------
# checkpoint loading
# ---------------------------------------------------------------------------


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(2, 3, 1)
        self.bn = torch.nn.BatchNorm2d(3)


def test_load_model_variables_reads_both_formats_and_reports(tmp_path):
    src = _Tiny()
    with torch.no_grad():
        for p in src.parameters():
            p.uniform_()
    sd = src.state_dict()
    del sd["bn.num_batches_tracked"]  # as the JAX package's exporter writes
    cases = {"wrapped.pth": {"model": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3},
             "bare.pt": dict(sd, **{"extra.weight": torch.zeros(1)})}
    for name, payload in cases.items():
        torch.save(payload, tmp_path / name)
        model = _Tiny()
        report = load_model_variables(str(tmp_path / name), model)
        assert report["missing"] == []
        assert report["unexpected"] == ([] if name == "wrapped.pth" else ["extra.weight"])
        assert sorted(report["converted"]) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(model.state_dict()[k], v), k
    torch.save({"conv.weight": torch.zeros(3, 2, 1, 1)}, tmp_path / "part.pth")
    assert "bn.weight" in load_model_variables(str(tmp_path / "part.pth"), _Tiny())["missing"]
    torch.save({"conv.weight": torch.zeros(4, 2, 1, 1)}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="conv.weight"):
        load_model_variables(str(tmp_path / "bad.pth"), _Tiny())
    with pytest.raises(NotImplementedError, match="orbax"):
        load_model_variables(str(tmp_path), _Tiny())
