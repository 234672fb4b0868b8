"""The port's avss eval and serving slice against the JAX package.

Trainer mel, the metric counters, the whole slice's logits and eval
accumulators (fusion kernel path on), and the serving ``Predictor``, each
on the same weights and numpy-seeded inputs in both packages. Shapes are
the small avss config of tests/test_pallas_fusion.py:82-84 (64x64, 5
classes, depth 18, f32); the slice at ResNet-50 width runs in
tests/test_torch_port_models.py, beside the ResNet-50 module tests whose
JAX compiles it shares. Tolerances are stated per test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.audio.mel import preprocess_audio as jax_preprocess_audio
from cavp_tpu.data.synthetic import synthetic_eval_batch as jax_synthetic_eval_batch
from cavp_tpu.engine import loops as jax_loops
from cavp_tpu.engine.predictor import Predictor as JaxPredictor
from cavp_tpu.metrics import fg_detect as jax_fg, miou as jax_miou
from cavp_tpu_torch.audio.mel import preprocess_audio
from cavp_tpu_torch.data.synthetic import synthetic_eval_batch
from cavp_tpu_torch.engine import loops
from cavp_tpu_torch.engine.predictor import Predictor
from cavp_tpu_torch.metrics import fg_detect, miou
from torch_port_common import model_pair

LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trainer_mel_matches_jax():
    wave = ((np.random.RandomState(0).rand(2, 2, 16000) - 0.5) * 0.4).astype(np.float32)
    ref = np.asarray(jax_preprocess_audio(jnp.asarray(wave), n_frames=96))
    got = preprocess_audio(torch.from_numpy(wave), n_frames=96)
    assert got.shape == ref.shape == (2, 2, 96, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the engine's wrapper keeps the JAX layout [N, T, 64, C]
    nhwc = loops.preprocess_audio(torch.from_numpy(wave), n_frames=96)
    np.testing.assert_allclose(
        nhwc.numpy(), np.asarray(jax_loops.preprocess_audio(jnp.asarray(wave), n_frames=96)),
        rtol=0, atol=1e-5)


def _labels(rng, n, num_classes, hw=(16, 16)):
    target = rng.randint(0, num_classes, (n,) + hw)
    target[rng.rand(*target.shape) < 0.1] = 255
    pred = rng.randint(0, num_classes, (n,) + hw)
    return target.astype(np.int32), pred.astype(np.int32)


def test_metric_counters_match_jax():
    """Exact counts in both packages on the same predictions."""
    rng = np.random.RandomState(1)
    C = 6
    target, pred = _labels(rng, 5, C)
    valid = np.array([1, 1, 0, 1, 1], np.float32)
    ms = np.array([0, 1, 0, 1, 0], np.float32)

    jm = jax_miou.miou_update_weighted(
        (jax_miou.miou_init(C),) * 2, jnp.asarray(pred), jnp.asarray(target),
        (jnp.asarray(valid), jnp.asarray(ms)))
    pm = miou.miou_update_weighted(
        (miou.miou_init(C),) * 2, torch.from_numpy(pred), torch.from_numpy(target),
        (torch.from_numpy(valid), torch.from_numpy(ms)))
    for j, p in zip(jm, pm):
        for name in ("inter", "union", "correct", "labeled"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)
        for a, b in zip(miou.miou_result(p), jax_miou.miou_result(j)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)

    jf = jax_fg.fg_update_weighted(
        (jax_fg.fg_init(C),) * 2, jnp.asarray(pred), jnp.asarray(target),
        (jnp.asarray(valid), jnp.asarray(ms)))
    pf = fg_detect.fg_update_weighted(
        (fg_detect.fg_init(C),) * 2, torch.from_numpy(pred), torch.from_numpy(target),
        (torch.from_numpy(valid), torch.from_numpy(ms)))
    for j, p in zip(jf, pf):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        for a, b in zip(fg_detect.fg_result(p), jax_fg.fg_result(j)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_fg_result_nan_when_no_class_valid():
    for got, ref in zip(fg_detect.fg_result(fg_detect.fg_init(4)),
                        jax_fg.fg_result(jax_fg.fg_init(4))):
        assert np.isnan(float(got)) and np.isnan(float(ref))


def test_multi_source_flag_matches_jax():
    labels = np.zeros((3, 32, 32), np.int32)
    labels[0, :8] = 1                   # 2 values over 100 px: single source
    labels[1, :8], labels[1, 8:16] = 1, 2   # 3 values: multi-source
    labels[2, :8], labels[2, 8:11] = 255, 3  # 255 counts; 3 has 96 px
    got = loops._multi_source_flag(torch.from_numpy(labels))
    ref = jax.vmap(jax_loops._multi_source_flag)(jnp.asarray(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.tolist() == [False, True, False]


@pytest.fixture(scope="module")
def small():
    return model_pair(seed=0, use_pallas_fusion=True)


def test_slice_logits_match_jax(small):
    model, cfg, jmodel, jcfg, jvars = small
    rng = np.random.RandomState(2)
    image = rng.randn(2, 64, 64, 3).astype(np.float32)
    audio = rng.randn(2, 96, 64, 1).astype(np.float32)
    ref = np.asarray(jax_loops.make_inference_forward(jmodel, jcfg)(
        jvars, jnp.asarray(image), jnp.asarray(audio)))
    for use_fused in (True, False):
        fwd = loops.make_inference_forward(model, cfg.replace(use_pallas_fusion=use_fused))
        got = fwd(torch.from_numpy(image), torch.from_numpy(audio))
        assert got.shape == ref.shape == (2, 64, 64, 5)
        np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)


def test_eval_step_matches_jax(small):
    """Accumulators within 2 pixel counts (test_pallas_fusion.py:149-156):
    an argmax may flip where two logits tie to float32 rounding."""
    model, cfg, jmodel, jcfg, jvars = small
    # 2 frames, the batch of test_slice_logits_match_jax: the JAX ops it
    # compiled there are reused
    batch = synthetic_eval_batch(cfg, 2, seed=3)
    jbatch = jax_synthetic_eval_batch(jcfg, 2, seed=3)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    ref = jax_loops.make_eval_step(jmodel, jcfg)(
        jvars, jax_loops.eval_metrics_init(jcfg.num_classes),
        {k: jnp.asarray(v) for k, v in jbatch.items()})
    got = loops.make_eval_step(model, cfg)(
        loops.eval_metrics_init(cfg.num_classes, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in ("miou_all", "miou_ms"):
        for f in ("inter", "union", "correct", "labeled"):
            np.testing.assert_allclose(getattr(getattr(got, name), f).numpy(),
                                       np.asarray(getattr(getattr(ref, name), f)),
                                       atol=2, err_msg=f"{name}.{f}")
    np.testing.assert_allclose(got.fg_all.numpy(), np.asarray(ref.fg_all), atol=2)
    np.testing.assert_allclose(got.fg_ms.numpy(), np.asarray(ref.fg_ms), atol=2)
    res = loops.eval_metrics_result(got)
    jres = jax_loops.eval_metrics_result(ref)
    for k in res:
        np.testing.assert_allclose(float(res[k]), float(jres[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)


def test_predictor_matches_jax(small, tmp_path):
    """Both packages' Predictors serve the same masks from one checkpoint:
    the JAX one loads the port's state dict as a reference .pth."""
    model, cfg, _, jcfg, _ = small
    sd = model.state_dict()
    path = str(tmp_path / "port.pth")
    torch.save({"model": sd}, path)
    jp = JaxPredictor(jcfg, ckpt_path=path, batch_sizes=(2,))
    p = Predictor(cfg, "cpu", batch_sizes=(2,), state_dict=sd)
    assert p.warmup() is p.warmup()

    rng = np.random.RandomState(5)
    images = rng.randint(0, 255, (3, 64, 64, 3)).astype(np.uint8)
    waves = ((rng.rand(3, 1, cfg.audio_samples) - 0.5) * 0.4).astype(np.float32)
    got = p.predict(images, waves)["mask"]  # 3 images: chunks of 2 + 1
    ref = jp.predict(images, waves)["mask"]
    assert got.shape == ref.shape == (3, 64, 64) and got.dtype == np.int32
    assert (got == ref).mean() >= 0.999
    np.testing.assert_array_equal(p.predict(images[:1], waves[:1])["mask"], got[:1])
    with pytest.raises(ValueError, match="compiled"):
        p.predict(images[:, :32], waves)
    with pytest.raises(ValueError, match="compiled"):
        p.predict(images, waves[..., :100])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cavp_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(cavp_tpu_torch.__path__, "
        "'cavp_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'cavp_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 36, names\n"
        "new = ['device', 'engine.optim', 'engine.schedules', 'engine.state', "
        "'losses.ce', 'losses.corocl', 'models.soundbank', 'ops.interp', "
        "'ops.kernels.fusion_train']\n"
        "missing = [n for n in new if 'cavp_tpu_torch.' + n not in names]\n"
        "assert not missing, missing\n"
        "print(len(names))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_the_cuda_device_and_never_to_the_cpu():
    """Without ``device`` every entry point that allocates asks for the
    card, and on a machine without one says so; ``device="cpu"`` works."""
    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.device import resolve_device
    from cavp_tpu_torch.engine.optim import make_optimizer
    from cavp_tpu_torch.engine.runner import build_model, init_state
    from cavp_tpu_torch.engine.state import create_train_state
    from cavp_tpu_torch.models.soundbank import init_bank

    assert not torch.cuda.is_available()  # the CPU test machine
    cfg = get_config("avss").replace(image_width=64, image_height=64, num_classes=5,
                                     visual_backbone=18, compute_dtype="float32", batch_size=2)
    model = build_model(cfg, "cpu", train=True)
    assert model.training and next(model.parameters()).device.type == "cpu"
    optimizers, _ = make_optimizer(model, cfg)
    calls = {
        "build_model": lambda: build_model(cfg),
        "Predictor": lambda: Predictor(cfg),
        "eval_metrics_init": lambda: loops.eval_metrics_init(5),
        "init_bank": lambda: init_bank(5, 2, 8),
        "create_train_state": lambda: create_train_state(model, optimizers, cfg),
        "init_state": lambda: init_state(cfg),
        "by name": lambda: resolve_device("cuda:0"),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    state = create_train_state(model, optimizers, cfg, "cpu")
    assert state.step == 0 and state.sound_bank.shape == (5, 2, cfg.audio_samples)
    assert state.sound_bank.device.type == "cpu"
