"""The port's AVSBench-Object J&F path against the JAX package's.

- ``metrics/jf.py``: the 255 thresholds and the buckets bit-equal; J, F
  and the multi-class accumulators within 1e-6, on frames with an empty
  ground truth, padded (weight 0) frames and probabilities planted exactly
  on thresholds;
- ``data/avsbench.py``: S4 and MS3 items, train and test, on a tiny tree
  written by ``make_synthetic_avsbench``: equal arrays, the audio windows
  included. The port decodes with PIL; the JAX package takes whatever path
  it takes on this machine (its native decoder where it builds), and its
  PIL path;
- ``make_jf_test_step`` and ``run_jf_test``: depth 18, 32x32, float32,
  2 classes, the JAX package's seeded weights carried into the port by
  ``state_dict_from_jax``: J, F and J&F within 1e-4, per video and over a
  split (``CAVP`` on MS3 under ``--resize_flag``, 4 videos a batch; the
  baseline ``VisualModel`` on S4, a video a batch); and the entry point
  ``python -m cavp_tpu_torch.test_avss_resize`` on a ``.pth`` of those
  weights, whose strict load reports nothing missing or unexpected.

The model runs are made once per run (``torch_port_common.once_per_run``)
and hold no model afterwards.
"""

import os
import random
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.data import avsbench as jax_avsbench
from cavp_tpu.data import pipeline as jax_pipeline
from cavp_tpu.engine import loops as jax_loops
from cavp_tpu.engine import runner as jax_runner
from cavp_tpu.metrics import jf as jax_jf
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.data import avsbench, pipeline
from cavp_tpu_torch.data.synthetic import make_synthetic_avsbench
from cavp_tpu_torch.engine import loops, runner
from cavp_tpu_torch.engine.convert import state_dict_from_jax
from cavp_tpu_torch.metrics import jf
from torch_port_common import once_per_run, release_after_module  # noqa: F401 (autouse)

SIZE, VIDEOS = 32, 3
SMALL = dict(image_width=SIZE, image_height=SIZE, visual_backbone=18, compute_dtype="float32",
             num_classes=2, num_workers=1)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _planted(rng, shape):
    """Probabilities in [0, 1], a quarter of them exactly on thresholds,
    some at 0 and 1."""
    th = np.asarray(jnp.linspace(0.0, 1.0 - 1e-10, 255))
    p = rng.rand(*shape).astype(np.float32)
    on = rng.rand(*shape) < 0.25
    p[on] = th[rng.randint(0, 255, on.sum())]
    p.reshape(-1)[:3] = [0.0, 1.0, th[1]]
    return p


def _video_arrays(seed=0, V=3, T=5, H=12, W=10):
    """probs, binary predictions, ground truth [V, T, H, W] and weights
    [V, T]: video 0 has an empty ground truth in frame 1, video 1 only empty
    ones, video 2 two padded frames."""
    rng = np.random.RandomState(seed)
    probs = _planted(rng, (V, T, H, W))
    gt = (rng.rand(V, T, H, W) < 0.3).astype(np.float32)
    gt[0, 1] = 0
    gt[1] = 0
    weight = np.ones((V, T), np.float32)
    weight[2, 3:] = 0
    return probs, (probs > 0.5).astype(np.float32), gt, weight


def test_thresholds_and_buckets_are_bit_equal():
    th = jf.thresholds().numpy()
    np.testing.assert_array_equal(th, np.asarray(jnp.linspace(0.0, 1.0 - 1e-10, 255)))
    np.testing.assert_array_equal(
        th, np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0 - 1e-10, 255))()))
    assert th.dtype == np.float32 and th[-1] == 1.0
    probs = _planted(np.random.RandomState(1), (4096,))
    probs[:255] = th  # every threshold itself
    got = torch.searchsorted(jf.thresholds(), torch.from_numpy(probs), right=True)
    ref = jnp.searchsorted(jnp.asarray(th), jnp.asarray(probs), side="right")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_pr_curves_match_jax():
    probs, _, gt, _ = _video_arrays()
    prec, recall = jf._pr_curves(torch.from_numpy(probs), torch.from_numpy(gt))
    f = jax.jit(jax.vmap(jax.vmap(jax_jf._pr_curves)))
    jprec, jrecall = f(jnp.asarray(probs), jnp.asarray(gt))
    assert prec.shape == (3, 5, 255)
    np.testing.assert_allclose(prec.numpy(), np.asarray(jprec), rtol=0, atol=1e-6)
    np.testing.assert_allclose(recall.numpy(), np.asarray(jrecall), rtol=0, atol=1e-6)


@pytest.mark.parametrize("weighted", [True, False], ids=["weights", "no-weights"])
def test_j_and_f_match_jax_per_video(weighted):
    probs, pred, gt, weight = _video_arrays()
    w = weight if weighted else None

    def jax_fn(p, m, g, w):
        j = jax.vmap(lambda a, b, c: jax_jf.mask_iou(a, b, weight=c))(m, g, w) \
            if w is not None else jax.vmap(jax_jf.mask_iou)(m, g)
        f = jax.vmap(lambda a, b, c: jax_jf.eval_fmeasure(a, b, weight=c))(p, g, w) \
            if w is not None else jax.vmap(jax_jf.eval_fmeasure)(p, g)
        return j, f

    jj, jf_ = jax.jit(jax_fn)(jnp.asarray(probs), jnp.asarray(pred), jnp.asarray(gt),
                              None if w is None else jnp.asarray(w))
    tw = None if w is None else torch.from_numpy(w)
    j = jf.mask_iou(torch.from_numpy(pred), torch.from_numpy(gt), weight=tw)
    f = jf.eval_fmeasure(torch.from_numpy(probs), torch.from_numpy(gt), weight=tw)
    assert j.shape == f.shape == (3,)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf_), rtol=0, atol=1e-6)
    # one video, no leading axis: a 0-dim result, as the JAX functions give
    j0 = jf.mask_iou(torch.from_numpy(pred[0]), torch.from_numpy(gt[0]), weight=None
                     if tw is None else tw[0])
    assert j0.dim() == 0 and abs(float(j0) - float(jj[0])) <= 1e-6
    assert float(f[1]) == 0.0  # no frame with an object: nothing kept


def test_color_miou_fscore_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 9, 11, 4).astype(np.float32)
    target = rng.randint(0, 4, (6, 9, 11)).astype(np.int32)
    target[0, :3] = 255
    target[1] = 0  # classes absent from a frame: 0/0 precision and recall
    weight = np.array([1, 1, 1, 0, 1, 0], np.float32)
    ref = jax.jit(jax_jf.color_miou_fscore)(jnp.asarray(logits), jnp.asarray(target),
                                            jnp.asarray(weight))
    got = jf.color_miou_fscore(torch.from_numpy(logits), torch.from_numpy(target),
                               torch.from_numpy(weight))
    for g, r in zip(got, ref):
        assert g.shape == (4,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("avsbench"))
    make_synthetic_avsbench(root, num_videos=VIDEOS, image_size=SIZE)
    return root


@pytest.fixture(params=["jax-default", "jax-pil"])
def jax_decoder(request, monkeypatch):
    """The JAX package's decode path: the one it takes on this machine
    (its native decoder, where ``cavp_tpu/native`` builds), or its PIL path
    (the native helpers off, as on a machine where it does not build)."""
    if request.param == "jax-pil":
        from cavp_tpu.data.transforms import VisualAugmentation as JaxVisualAugmentation

        for name in ("native_eval_batch", "native_open_rgb", "native_open_binary_mask"):
            monkeypatch.setattr(JaxVisualAugmentation, name, lambda *a, **k: None)
    return request.param


@pytest.mark.parametrize("split", ["test", "train"])
@pytest.mark.parametrize("name", ["S4Dataset", "MS3Dataset"])
def test_items_match_jax(tree, name, split, jax_decoder):
    """Equal arrays. Against the JAX native decoder's test frames, which
    it normalizes in C++ in another float32 order, the frames within 1e-6
    (the inputs are in [-2.2, 2.7]: a few ulp); all else bit-equal."""
    kw = dict(SMALL, data_root=tree)
    ds = getattr(avsbench, name)(get_config("avss_binary").replace(**kw), split)
    jds = getattr(jax_avsbench, name)(jax_get_config("avss_binary").replace(**kw), split)
    assert len(ds) == len(jds) == (VIDEOS * 10 if (name, split) == ("MS3Dataset", "train")
                                   else VIDEOS)
    exact = jax_decoder == "jax-pil" or split == "train"
    for i in range(len(ds)):
        random.seed(i)
        got = ds[i]
        random.seed(i)
        ref = jds[i]
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            if isinstance(v, str):
                assert got[k] == v
                continue
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            msg = f"{name} {split} {i} {k}"
            if k == "image" and not exact:
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=msg)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=msg)
    if split == "test":  # five 2 s windows, then zero rows; masks with an object
        assert got["waveform"].shape == (10, 32000) and not got["waveform"][5:].any()
        assert got["pix_label"][:5].max() == 1 and set(np.unique(got["pix_label"])) == {0, 1}


# ---------------------------------------------------------------------------
# the J&F step, run_jf_test and the entry point
# ---------------------------------------------------------------------------


def _loader(pkg, ds, config):
    per_batch = 4 if config.resize_flag else 1
    return pkg.DataLoader(ds, per_batch, pkg.collate_eval_videos, num_workers=1)


def _jf_report(root):
    """J and F per video of one MS3 batch, and the J&F test over MS3 (CAVP,
    4 videos a batch) and over S4 (the baseline, a video a batch), in both
    packages; the port's entry point on a ``.pth`` of the same weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for kind, splits in (("cavp", ("v1m",)), ("baseline", ("v1s",))):
        kw = dict(SMALL, data_root=root, use_baseline=kind == "baseline")
        jcfg = jax_get_config("avss_binary").replace(**kw)
        jmodel = jax_runner.build_model(jcfg)
        audio = None if kind == "baseline" else jnp.zeros((1, 96, 64, 1))
        jvars = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, SIZE, SIZE, 3)), audio,
                                              eval_mode=True))(jax.random.PRNGKey(3))
        cfg = get_config("avss_binary").replace(**kw)
        model = runner.build_model(cfg, "cpu")
        sd = state_dict_from_jax(jax.device_get(jvars["params"]),
                                 jax.device_get(jvars["batch_stats"]))
        model.load_state_dict(sd, strict=True)
        state = types.SimpleNamespace(params=jvars["params"], batch_stats=jvars["batch_stats"])
        for split in splits:
            resize = split == "v1m"
            c, jc = (x.replace(avsbench_split=split, resize_flag=resize) for x in (cfg, jcfg))
            D = avsbench.S4Dataset if split == "v1s" else avsbench.MS3Dataset
            JD = jax_avsbench.S4Dataset if split == "v1s" else jax_avsbench.MS3Dataset
            ds, jds = D(c, "test"), JD(jc, "test")
            key = f"{kind}/{split}"
            out[key] = dict(
                port=runner.run_jf_test(c, model, _loader(pipeline, ds, c), "cpu"),
                jax=jax_runner.run_jf_test(jc, jmodel, state, _loader(jax_pipeline, jds, jc)))
            if kind == "cavp" and split == "v1m":  # per video, one batch
                batch = pipeline.collate_eval_videos([ds[i] for i in range(VIDEOS)])
                for k in ("name", "img_label", "frame_available"):
                    batch.pop(k)
                j, f = loops.make_jf_test_step(model, c)(
                    {k: torch.from_numpy(v) for k, v in batch.items()})
                jj, jf_ = jax.jit(jax_loops.make_jf_test_step(jmodel, jc))(
                    jvars, {k: jnp.asarray(v) for k, v in batch.items()})
                out["per_video"] = dict(port=(j.numpy(), f.numpy()),
                                        jax=(np.asarray(jj), np.asarray(jf_)))
        if kind == "cavp":
            from cavp_tpu_torch import test_avss_resize

            path = os.path.join(root, "cavp_avsobj_ss.pth")
            torch.save({"model": {"module." + k: v for k, v in model.state_dict().items()}},
                       path)
            loaded = {}
            out["entry_point"] = dict(
                results=test_avss_resize.main(
                    ["--setup", "avss_binary", "--data_root", root, "--avsbench_split", "v1m",
                     "--resize_flag", "--visual_backbone", "18", "--compute_dtype", "float32",
                     "--num_workers", "1", "--ckpt_path", path], device="cpu", report=loaded),
                missing=loaded["missing"], unexpected=loaded["unexpected"])
        del model, jmodel, jvars, state
    return out


@pytest.fixture(scope="module")
def jf_report(tree):
    # the entry point reads SIZE from the files: no resize of the J&F items
    return once_per_run("jf_report", lambda: _jf_report(tree))


def test_jf_step_matches_jax_per_video(jf_report):
    (j, f), (jj, jf_) = jf_report["per_video"]["port"], jf_report["per_video"]["jax"]
    assert j.shape == f.shape == jj.shape == (VIDEOS,)
    np.testing.assert_allclose(j, jj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(f, jf_, rtol=0, atol=1e-4)
    assert np.all(np.isfinite(j)) and np.all(np.isfinite(f))


@pytest.mark.parametrize("key", ["cavp/v1m", "baseline/v1s"])
def test_run_jf_test_matches_jax(jf_report, key):
    got, ref = jf_report[key]["port"], jf_report[key]["jax"]
    assert sorted(got) == sorted(ref) == ["F_score", "J&F", "miou"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])


def test_entry_point_loads_strictly_and_gives_run_jf_test(jf_report):
    e = jf_report["entry_point"]
    assert e["missing"] == [] and e["unexpected"] == []
    for k, v in jf_report["cavp/v1m"]["port"].items():
        assert abs(e["results"][k] - v) <= 1e-6, k


def test_entry_point_needs_a_j_and_f_split(tmp_path):
    from cavp_tpu_torch import test_avss_resize

    with pytest.raises(ValueError, match="v1s"):
        test_avss_resize.main(["--setup", "avss_binary", "--avsbench_split", "all"],
                              device="cpu")
