"""The port's avss eval and serving slice against the JAX package.

Trainer mel, the metric counters, the whole slice's logits and eval
accumulators (fusion kernel path on, then every kernel flag on: mel,
layer1, fusion, upsample + argmax), and the serving ``Predictor``, each
on the same weights and numpy-seeded inputs in both packages. Shapes are
the small avss config of tests/test_pallas_fusion.py:82-84 (64x64, 5
classes, depth 18, f32); the slice at ResNet-50 width runs in
tests/test_torch_port_models.py, beside the ResNet-50 module tests whose
JAX compiles it shares. Tolerances are stated per test.
"""

import functools
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
from torch_port_common import model_pair, release_after_module  # noqa: F401 (autouse)

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
        (miou.miou_init(C, device="cpu"),) * 2, torch.from_numpy(pred), torch.from_numpy(target),
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
        (fg_detect.fg_init(C, device="cpu"),) * 2, torch.from_numpy(pred), torch.from_numpy(target),
        (torch.from_numpy(valid), torch.from_numpy(ms)))
    for j, p in zip(jf, pf):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        for a, b in zip(fg_detect.fg_result(p), jax_fg.fg_result(j)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_fg_result_nan_when_no_class_valid():
    for got, ref in zip(fg_detect.fg_result(fg_detect.fg_init(4, device="cpu")),
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
    ref = np.asarray(jax.jit(jax_loops.make_inference_forward(jmodel, jcfg))(
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
    ref = jax.jit(jax_loops.make_eval_step(jmodel, jcfg))(
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


ALL_FLAGS = dict(use_pallas_fusion=True, use_pallas_mel=True, use_pallas_layer1=True,
                 use_pallas_argmax=True)
ALL_OFF = dict.fromkeys(ALL_FLAGS, False)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX mel kernel has no interpret switch of its own
    (tests/test_pallas_mel.py patches ``pallas_call`` the same way)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _accumulators(m):
    return {"miou_all": m.miou_all, "miou_ms": m.miou_ms}, {"fg_all": m.fg_all, "fg_ms": m.fg_ms}


def test_eval_step_with_every_kernel_flag_matches_jax(small, jax_interpret):
    """All four flags on in both packages (the JAX kernels in interpret
    mode, the port's wrappers on their plain versions): accumulators within
    2 pixel counts, as with the fusion kernel alone, and the port's
    all-flags arm within 2 of its own plain arm."""
    model, cfg, jmodel, jcfg, jvars = small
    batch = synthetic_eval_batch(cfg, 2, seed=3)
    ref = jax.jit(jax_loops.make_eval_step(jmodel, jcfg.replace(**ALL_FLAGS)))(
        jvars, jax_loops.eval_metrics_init(jcfg.num_classes),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, plain = (loops.make_eval_step(model, cfg.replace(**flags))(
        loops.eval_metrics_init(cfg.num_classes, "cpu"), tbatch)
        for flags in (ALL_FLAGS, ALL_OFF))
    for other, to_np in ((ref, np.asarray), (plain, lambda t: t.numpy())):
        for name in ("miou_all", "miou_ms"):
            for f in ("inter", "union", "correct", "labeled"):
                np.testing.assert_allclose(getattr(getattr(got, name), f).numpy(),
                                           to_np(getattr(getattr(other, name), f)),
                                           atol=2, err_msg=f"{name}.{f}")
        np.testing.assert_allclose(got.fg_all.numpy(), to_np(other.fg_all), atol=2)
        np.testing.assert_allclose(got.fg_ms.numpy(), to_np(other.fg_ms), atol=2)
    assert float(got.miou_all.labeled) == 2 * 64 * 64


def test_flags_off_is_the_module_composition_bit_for_bit(small):
    """No flag: the eval step is the model's own forward, its argmax and
    the metric updates, nothing else."""
    model, cfg, _, _, _ = small
    off = cfg.replace(**ALL_OFF)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_eval_batch(cfg, 2, seed=4).items()}
    got = loops.make_eval_step(model, off)(loops.eval_metrics_init(cfg.num_classes, "cpu"), batch)
    with torch.no_grad():
        audio = preprocess_audio(batch["waveform"], n_frames=cfg.mel_frames,
                                 spec_min=cfg.spec_min, spec_max=cfg.spec_max)
        logits, _, _ = model(batch["image"].permute(0, 3, 1, 2), audio)
        pred = logits.permute(0, 2, 3, 1).argmax(-1).to(torch.int32)
    assert torch.equal(loops.make_eval_pred_forward(model, off)(
        batch["image"], audio.permute(0, 2, 3, 1)), pred)
    valid = batch["valid"].double()
    ms = loops._multi_source_flag(batch["pix_label"]).double() * valid
    init = loops.eval_metrics_init(cfg.num_classes, "cpu")
    m_all, m_ms = miou.miou_update_weighted((init.miou_all, init.miou_ms), pred,
                                            batch["pix_label"], (valid, ms))
    f_all, f_ms = fg_detect.fg_update_weighted((init.fg_all, init.fg_ms), pred,
                                               batch["pix_label"], (valid, ms))
    for a, b in zip((*got.miou_all, *got.miou_ms, got.fg_all, got.fg_ms),
                    (*m_all, *m_ms, f_all, f_ms)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags", [dict(use_pallas_layer1=True),
                                   dict(use_pallas_layer1=True, use_pallas_fusion=True)],
                         ids=["layer1", "layer1+fusion"])
def test_inference_forward_with_the_layer1_flag_matches_plain_and_jax(small, flags):
    """rtol = atol = 2e-4 against the port's plain forward
    (tests/test_layer1_kernel.py's tolerance for the same comparison) and
    the slice's 1e-3 against the JAX forward with the same flags."""
    model, cfg, jmodel, jcfg, jvars = small
    rng = np.random.RandomState(2)
    image = rng.randn(2, 64, 64, 3).astype(np.float32)
    audio = rng.randn(2, 96, 64, 1).astype(np.float32)
    on = dict(ALL_OFF, **flags)
    got = loops.make_inference_forward(model, cfg.replace(**on))(
        torch.from_numpy(image), torch.from_numpy(audio))
    plain = loops.make_inference_forward(model, cfg.replace(**ALL_OFF))(
        torch.from_numpy(image), torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4, atol=2e-4)
    assert not torch.equal(got, plain)  # another path did run
    ref = np.asarray(jax.jit(jax_loops.make_inference_forward(jmodel, jcfg.replace(**on)))(
        jvars, jnp.asarray(image), jnp.asarray(audio)))
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)


def test_argmax_flag_needs_the_fusion_flag_and_keeps_the_masks(small, monkeypatch):
    """The upsample + argmax kernel is reachable only in the fusion branch;
    there it gives the masks of the separable resize arm bit for bit."""
    model, cfg, _, _, _ = small
    calls = []
    real = loops.upsample_argmax
    monkeypatch.setattr(loops, "upsample_argmax",
                        lambda x, hw: calls.append(tuple(x.shape)) or real(x, hw))
    rng = np.random.RandomState(6)
    image = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    audio = torch.from_numpy(rng.randn(2, 96, 64, 1).astype(np.float32))
    pred = lambda **flags: loops.make_eval_pred_forward(
        model, cfg.replace(**dict(ALL_OFF, **flags)))(image, audio)
    alone = pred(use_pallas_argmax=True)
    assert calls == [] and torch.equal(alone, pred())
    fused = pred(use_pallas_fusion=True)
    both = pred(use_pallas_fusion=True, use_pallas_argmax=True)
    assert calls == [(2, 16, 16, 5)]
    assert both.dtype == torch.int32 and torch.equal(both, fused)
    assert (both == alone).float().mean() >= 0.999


def test_predictor_reaches_layer1_and_the_fusion_kernel_with_every_flag_on(small, monkeypatch):
    """Serving builds on ``make_inference_forward``: layer1 and the fusion
    kernel's wrappers are called once per chunk; the mel stays the plain one
    and the argmax runs over the full logits, as in the JAX Predictor."""
    model, cfg, _, _, _ = small
    calls = {"layer1": 0, "fusion": 0, "mel": 0, "argmax": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    import cavp_tpu_torch.ops.kernels.mel as mel_module
    monkeypatch.setattr(loops, "fused_layer1", counted("layer1", loops.fused_layer1))
    monkeypatch.setattr(loops, "fused_visual_fusion", counted("fusion", loops.fused_visual_fusion))
    monkeypatch.setattr(loops, "upsample_argmax", counted("argmax", loops.upsample_argmax))
    monkeypatch.setattr(mel_module, "fused_log_mel", counted("mel", mel_module.fused_log_mel))
    sd = model.state_dict()
    p = Predictor(cfg.replace(**ALL_FLAGS), "cpu", batch_sizes=(2,), state_dict=sd)
    plain = Predictor(cfg.replace(**ALL_OFF), "cpu", batch_sizes=(2,), state_dict=sd)
    rng = np.random.RandomState(5)
    images = rng.randint(0, 255, (3, 64, 64, 3)).astype(np.uint8)
    waves = ((rng.rand(3, 1, cfg.audio_samples) - 0.5) * 0.4).astype(np.float32)
    got = p.predict(images, waves)["mask"]  # chunks of 2 + 1
    assert calls == {"layer1": 2, "fusion": 2, "mel": 0, "argmax": 0}
    assert (got == plain.predict(images, waves)["mask"]).mean() >= 0.999
    assert calls == {"layer1": 2, "fusion": 2, "mel": 0, "argmax": 0}


def test_eval_and_train_steps_pass_the_mel_flag(monkeypatch):
    from cavp_tpu_torch.config import get_config
    from cavp_tpu_torch.data.synthetic import synthetic_train_batch
    from cavp_tpu_torch.engine.runner import init_state

    seen = []
    real = loops._preprocess_nchw
    monkeypatch.setattr(loops, "_preprocess_nchw",
                        lambda wave, **kw: seen.append(kw["use_pallas"]) or real(wave, **kw))
    cfg = get_config("avss").replace(image_width=64, image_height=64, num_classes=5,
                                     visual_backbone=18, compute_dtype="float32",
                                     batch_size=2, max_view=8, class_slots=3)
    losses = []
    for flag in (True, False):
        c = cfg.replace(use_pallas_mel=flag)
        state = init_state(c, "cpu", steps_per_epoch=4)
        batch = {k: torch.from_numpy(v) for k, v in synthetic_train_batch(c, seed=0).items()}
        _, m = loops.make_train_step(state.model, state.optimizers, c)(state, batch, 0)
        losses.append(float(m["loss/loss"]))
        ebatch = {k: torch.from_numpy(v) for k, v in synthetic_eval_batch(c, 2, seed=1).items()}
        loops.make_eval_step(state.model.eval(), c)(
            loops.eval_metrics_init(c.num_classes, "cpu"), ebatch)
    assert seen == [True, True, False, False]
    # the two frontends agree to 2e-6 on the mel; the loss follows
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


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
        "('jax', 'jaxlib', 'flax', 'cavp_tpu', 'pandas'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 65, names\n"
        "new = ['device', 'engine.optim', 'engine.schedules', 'engine.state', "
        "'losses.ce', 'losses.corocl', 'models.soundbank', 'ops.interp', "
        "'ops.kernels.fusion_train', 'ops.kernels.mel', "
        "'ops.kernels.upsample_argmax', 'ops.kernels.layer1', 'config.flags', "
        "'data.audio_io', 'data.imageio', 'data.transforms', 'data.avss', "
        "'data.pipeline', 'engine.checkpoint', 'test_avs_semantic', 'main_avss', "
        "'main_avss_resize', 'utils', 'utils.wandb_logger', 'data.avsbench', "
        "'metrics.jf', 'test_avss_resize', 'config.class_list', 'data.vpo', "
        "'main_vpo_mono', 'main_vpo_stereo', 'models.audio_nets', 'data.synthetic', "
        "'models.hrnet', 'models.ocr', 'models.pvt', 'models.conv25d', "
        "'losses.contrast_extra', 'losses.ohem', 'metrics.localization']\n"
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
        "miou_init": lambda: miou.miou_init(5),
        "fg_init": lambda: fg_detect.fg_init(5),
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
    assert miou.miou_init(5, device="cpu").inter.device.type == "cpu"
    assert fg_detect.fg_init(5, device="cpu").device.type == "cpu"
