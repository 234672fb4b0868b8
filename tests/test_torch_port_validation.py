"""The port's evaluation entry point against the JAX package's.

One run of each, on the same files: the JAX package's writer makes an
AVSBench-Semantics test split (48x48, 3 videos: one each of v1s, v1m and
v2; the v1m masks get a second object, so the multi-source subset is not
empty), JAX variables are drawn from a seeded numpy generator and written
as a reference ``.pth`` by ``cavp_tpu.engine.convert.export_torch_state_dict``.
The JAX package loads it with its own ``load_model_variables`` and runs its
``run_validation``; the port runs ``cavp_tpu_torch.test_avs_semantic.main``
with the same command line on the CPU. Both are float32 with
``visual_backbone=18`` (as ``tests/test_e2e.py``), 71 classes (the avss
setup's), and the entry point's own batching (1 video a batch, the padding
frames repacked away: 20 valid frames of 30 slots in 2 steps of 10).

The two runs are made once per test run by the first worker that asks
(``once_per_run``: about 15 s); the tests read their results. The ten metrics agree
within 1e-3 absolute (an argmax may flip where two float32 logits are a
rounding apart; NaN where both are NaN).

The runner's own contract (one transfer of the metrics at the end, the
options it does not have) is tested on a stand-in step: no model.
"""

import os
import shutil
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import load_args_and_config as jax_load_args_and_config
from cavp_tpu.data.avss import AVSSDataset as JaxAVSSDataset
from cavp_tpu.data.pipeline import DataLoader as JaxDataLoader
from cavp_tpu.data.pipeline import collate_eval_videos as jax_collate_eval_videos
from cavp_tpu.data.synthetic import make_synthetic_avss as jax_make_synthetic_avss
from cavp_tpu.engine.checkpoint import load_model_variables as jax_load_model_variables
from cavp_tpu.engine.convert import export_torch_state_dict
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu.engine.runner import run_validation as jax_run_validation
from cavp_tpu_torch import test_avs_semantic
from cavp_tpu_torch.config import load_args_and_config
from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
from cavp_tpu_torch.engine import loops, runner
from torch_port_common import (  # noqa: F401 (release_after_module: autouse)
    configs,
    once_per_run,
    release_after_module,
)

METRIC_ATOL = 1e-3
SIZE = 48
ARGV = ["--setup", "avss", "--visual_backbone", "18", "--compute_dtype", "float32",
        "--num_workers", "2"]
METRICS = ("miou", "acc", "fdr", "f_1", "f_0.3", "miou_ms", "acc_ms", "fdr_ms", "f_1_ms",
           "f_0.3_ms")


def _seeded_variables(jmodel, seed=0):
    """JAX variables drawn from numpy: He-scaled kernels, BatchNorm and
    LayerNorm off identity; the classifier's bias favours the tree's six
    classes, so some pixels of both subsets are found."""
    shapes = jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 96, 64, 1)),
                              eval_mode=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)  # float32 draws: the VGG tower has 70 M weights
    normal = lambda shape: rng.standard_normal(shape, np.float32)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            v = normal(s.shape) * np.float32(np.sqrt(2.0 / np.prod(s.shape[:-1])))
        elif name == "scale":
            v = 1.0 + 0.2 * normal(s.shape)
        elif name == "mean":
            v = 0.2 * normal(s.shape)
        elif name == "var":
            v = 0.5 + rng.random(s.shape, np.float32)
        else:  # biases, position embeddings
            v = 0.1 * normal(s.shape)
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    variables["params"]["segment"]["upsample"]["classifier"]["bias"][:6] += 2.0
    return variables


def _reports():
    """The JAX package's and the port's runs on one tree and one .pth."""
    root = tempfile.mkdtemp(prefix="torch_port_validation_")
    try:
        base = jax_make_synthetic_avss(root, num_videos=3, image_size=SIZE, num_classes=6,
                                       splits=("test",))
        mdir = os.path.join(base, "v1m", "test_vid1", "labels_semantic")
        from PIL import Image
        for f in os.listdir(mdir):  # a second sounding object: multi-source frames
            m = np.array(Image.open(os.path.join(mdir, f)))
            m[-14:, :14] = 5
            Image.fromarray(m).save(os.path.join(mdir, f))
        pth = os.path.join(root, "avss.pth")
        argv = ARGV + ["--root_dataset_dir", root, "--ckpt_path", pth]

        jcfg = jax_load_args_and_config(argv)
        jmodel = jax_build_model(jcfg)
        variables = _seeded_variables(jmodel)
        sd = export_torch_state_dict(variables["params"], variables["batch_stats"])
        torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}}, pth)
        zeros = jax.tree_util.tree_map(np.zeros_like, variables)
        params, stats, jreport = jax_load_model_variables(pth, zeros["params"],
                                                          zeros["batch_stats"])
        loader = JaxDataLoader(JaxAVSSDataset(jcfg, "test"), 1, jax_collate_eval_videos,
                               num_workers=jcfg.num_workers)
        jres = jax_run_validation(jcfg, jmodel,
                                  SimpleNamespace(params=params, batch_stats=stats), loader)

        reports = []
        real = test_avs_semantic.load_model_variables
        test_avs_semantic.load_model_variables = lambda *a: reports.append(real(*a)) or reports[-1]
        try:
            run = {}
            res = test_avs_semantic.main(argv, device="cpu", stats=run)
        finally:
            test_avs_semantic.load_model_variables = real
        return {"jax": jres, "port": res, "report": reports[0], "stats": run,
                "jax_report": jreport, "exported": sorted(sd)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def reports():
    return once_per_run("validation_reports", _reports)


def test_entry_point_metrics_match_jax_run_validation(reports):
    jres, res = reports["jax"], reports["port"]
    assert sorted(res) == sorted(jres) == sorted(METRICS)
    for k in METRICS:
        if np.isnan(jres[k]):
            assert np.isnan(res[k]), k
        else:
            assert abs(res[k] - jres[k]) <= METRIC_ATOL, (k, res[k], jres[k])
    # not an empty comparison: classes are found, in both subsets
    assert 0 < jres["miou"] < 1 and 0 < jres["miou_ms"] < 1
    assert 0 < jres["f_1"] < 1 and 0 < jres["acc_ms"] < 1


def test_entry_point_loads_the_exported_pth_strictly(reports):
    """Nothing missing, nothing unexpected: every tensor the JAX package's
    exporter wrote has its place under the reference's name."""
    report = reports["report"]
    assert report["missing"] == [] and report["unexpected"] == []
    assert sorted(report["converted"]) == reports["exported"]
    assert reports["jax_report"]["missing"] == reports["jax_report"]["unexpected"] == []


def test_entry_point_batches_as_the_jax_package(reports):
    """1 video a batch, flattened, repacked: 20 valid frames in 2 steps."""
    assert reports["stats"]["frames"] == 20 and reports["stats"]["steps"] == 2
    assert 0 <= reports["stats"]["loader_wait_s"] <= reports["stats"]["wall_s"]


def test_entry_point_asks_for_the_card_by_default(tmp_path):
    assert not torch.cuda.is_available()  # the CPU test machine
    with pytest.raises(RuntimeError, match="CUDA"):
        test_avs_semantic.main(ARGV + ["--root_dataset_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the runner, on a stand-in step
# ---------------------------------------------------------------------------


def _video_batches(n_videos, seed=0):
    """Collated eval batches of one video, as the loader gives them."""
    rng = np.random.RandomState(seed)
    for v in range(n_videos):
        valid = np.zeros((1, 10), np.float32)
        valid[0, :5 if v % 2 else 10] = 1
        yield {"image": rng.randn(1, 10, 8, 8, 3).astype(np.float32),
               "waveform": rng.randn(1, 10, 1, 16).astype(np.float32),
               "pix_label": rng.randint(0, 3, (1, 10, 8, 8)).astype(np.int32),
               "img_label": np.zeros((1, 10, 3), np.int32), "name": [f"v{v}"],
               "frame_available": valid.copy(), "valid": valid}


SYNCS = ("item", "tolist", "cpu", "numpy", "__float__", "__int__", "__bool__")


def test_run_validation_transfers_the_metrics_once_at_the_end(monkeypatch):
    """The accumulators stay tensors from step to step, nothing leaves
    them for the host in the loop, and the ten metrics come over in one
    transfer after the last step."""
    events = []
    for name in SYNCS:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _name=name, _real=real, **kw):
            events.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, spy)

    def make_step(model, config):
        def step(metrics, batch):
            assert all(isinstance(t, torch.Tensor) for t in (*metrics.miou_all, metrics.fg_all))
            assert all(isinstance(t, torch.Tensor) for t in batch.values())
            events.append(("step", batch["image"].shape[0]))
            inter = metrics.miou_all.inter + batch["valid"].sum()
            return metrics._replace(miou_all=metrics.miou_all._replace(inter=inter))
        return step

    monkeypatch.setattr(runner, "make_eval_step", make_step)
    config = load_args_and_config(["--setup", "avss"])
    stats = {}
    res = runner.run_validation(config, None, _video_batches(3), "cpu", stats=stats)
    # 25 valid frames repacked by 10, the last batch padded with 5 invalid ones
    assert events == [("step", 10)] * 3 + ["tolist"]
    assert stats["steps"] == 3 and stats["frames"] == 25
    assert sorted(res) == sorted(METRICS) and all(isinstance(v, float) for v in res.values())
    # the stand-in counted 25 into every class's intersection, and no union
    assert res["miou"] == pytest.approx(25 / 2.220446049250313e-16, rel=1e-12)


def test_run_validation_hands_the_kernel_flags_to_the_eval_step(monkeypatch):
    seen = []
    monkeypatch.setattr(runner, "make_eval_step",
                        lambda model, config: seen.append(config) or (lambda m, b: m))
    flags = ("use_pallas_fusion", "use_pallas_mel", "use_pallas_layer1", "use_pallas_argmax")
    config = load_args_and_config(["--setup", "avss", *(f"--{f}" for f in flags)])
    runner.run_validation(config, None, _video_batches(1), "cpu")
    assert all(getattr(seen[0], f) for f in flags)
    flat = []
    monkeypatch.setattr(runner, "make_eval_step",
                        lambda model, config: lambda m, b: flat.append(b["image"].shape) or m)
    runner.run_validation(config.replace(eval_dense_pack=False), None, _video_batches(2), "cpu")
    assert flat == [(10, 8, 8, 3)] * 2  # without the repack: every slot


def test_run_validation_options_not_ported_raise(monkeypatch):
    config = load_args_and_config(["--setup", "avss"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        runner.run_validation(config, None, [], "cpu", wandb_=object())
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        runner.run_validation(config, None, [], "cpu")


def test_eval_step_copies_no_host_array_and_sizes_nothing_from_the_data(monkeypatch):
    """After its first call (which fills the caches), the eval step makes
    no tensor from host memory and calls no ``torch.bincount``: on the card
    either makes the host wait for the device, so the loop above it could
    not run ahead. The plain log-mel once uploaded its bases and
    filterbank on every call, the separable resize its matrices, and the
    metrics' histograms sized themselves from the data."""
    cfg, _ = configs()
    model = runner.build_model(cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_eval_batch(cfg, 2, seed=0).items()}
    for flags in ({}, {"use_pallas_fusion": True}):
        step = loops.make_eval_step(model, cfg.replace(**flags))
        metrics = step(loops.eval_metrics_init(cfg.num_classes, "cpu"), batch)
        made = []
        for name in ("from_numpy", "tensor", "as_tensor"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, lambda *a, _real=real, _name=name, **kw:
                                made.append(_name) or _real(*a, **kw))
        monkeypatch.setattr(torch, "bincount", lambda *a, **kw: made.append("bincount"))
        step(metrics, batch)
        monkeypatch.undo()
        assert made == [], (flags, made)
