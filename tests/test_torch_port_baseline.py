"""The baseline model and the binary setup's train steps against the JAX
package.

- ``VisualModel`` (``--use_baseline``): its logits, its ``.pth`` (loaded
  strictly by both packages), the weight bridge, its CE-only train step,
  and its eval step with every kernel flag on, which runs the plain
  forward as the JAX package's does (the fusion, layer1 and argmax flags
  need the decomposed methods ``VisualModel`` lacks; only the log-mel
  kernel, which the eval step runs for any model, is reached);
- the ``avss_binary`` train step of ``CAVP``: 2 classes, the 71-wide
  one-hot labels of the binary setup's items, no sound bank and no
  overwrite, one step.

Shapes: depth 18, 48x48, float32, batch 4. Tolerances: logits as the avss
model tests hold the slice (rtol 1e-3 / atol 1e-3); the train steps with
``tests/test_torch_port_train_step.py``'s float32 limits for a first step
(losses rtol 5e-5; BatchNorm statistics 1e-4 of each tensor's largest
entry; parameter deltas per tensor, L2 of the difference over L2 of the
delta: classifier 5e-3, fusion group median 2e-2 / worst 5e-2, head
groups 5e-2 / 0.15, backbone groups 0.12 / 0.2; Adam every element at most
``lr`` long and 80% within 1% of ``lr`` of the JAX step's).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.engine import loops as jax_loops
from cavp_tpu.engine.checkpoint import load_model_variables as jax_load_model_variables
from cavp_tpu.engine.convert import import_torch_state_dict
from cavp_tpu.engine.optim import make_optimizer as jax_make_optimizer
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu.engine.state import TrainState as JaxTrainState
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.data.synthetic import synthetic_eval_batch, synthetic_train_batch
from cavp_tpu_torch.engine import loops
from cavp_tpu_torch.engine.checkpoint import load_model_variables
from cavp_tpu_torch.engine.convert import state_dict_from_jax
from cavp_tpu_torch.engine.optim import label_params, make_optimizer
from cavp_tpu_torch.engine.runner import build_model
from cavp_tpu_torch.engine.state import create_train_state
from cavp_tpu_torch.models.cavp import CAVP, VisualModel
from torch_port_common import release_after_module, release_memory  # noqa: F401 (autouse)
from torch_ref import randomize_bn_stats

SIZE, BATCH, SPE, RNG_SEED = 48, 4, 4, 7
SMALL = dict(image_width=SIZE, image_height=SIZE, visual_backbone=18,
             compute_dtype="float32", batch_size=BATCH, max_view=8, class_slots=3, epochs=2)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
ALL_FLAGS = dict(use_pallas_fusion=True, use_pallas_mel=True, use_pallas_layer1=True,
                 use_pallas_argmax=True)


def _pair(baseline, seed=0):
    """(port model, port config, JAX model, JAX config, JAX variables):
    the binary setup, one model in both packages."""
    kw = dict(SMALL, use_baseline=baseline)
    cfg, jcfg = get_config("avss_binary").replace(**kw), jax_get_config("avss_binary").replace(**kw)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    randomize_bn_stats(model, seed)
    jmodel = jax_build_model(jcfg)
    audio = None if baseline else jnp.zeros((1, 96, 64, 1))
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, SIZE, SIZE, 3)), audio,
                                                  eval_mode=True), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, report = import_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()},
        zeros["params"], zeros["batch_stats"])
    assert not report["missing"] and not report["unexpected"], report
    return model, cfg, jmodel, jcfg, {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def baseline():
    return _pair(baseline=True)


def test_build_model_gives_the_visual_model(baseline):
    model, cfg, jmodel, _, _ = baseline
    assert type(model) is VisualModel and type(jmodel).__name__ == "VisualModel"
    assert not loops._decomposable(model) and not hasattr(model, "seg_model")
    assert isinstance(build_model(cfg.replace(use_baseline=False), "cpu"), CAVP)
    names = list(model.state_dict())
    assert all(n.startswith(("backbone.backbone.", "segment.")) for n in names)


def test_visual_model_logits_match_jax(baseline):
    model, cfg, jmodel, jcfg, jvars = baseline
    rng = np.random.RandomState(2)
    image = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    audio = rng.randn(2, 96, 64, 1).astype(np.float32)  # ignored by both
    ref = np.asarray(jax.jit(jax_loops.make_inference_forward(jmodel, jcfg))(
        jvars, jnp.asarray(image), jnp.asarray(audio)))
    got = loops.make_inference_forward(model, cfg)(torch.from_numpy(image),
                                                   torch.from_numpy(audio))
    assert got.shape == ref.shape == (2, SIZE, SIZE, 2)
    np.testing.assert_allclose(got.numpy(), ref, **LOGIT_TOL)


def test_baseline_pth_loads_strictly_in_both_packages(baseline, tmp_path):
    """The port's state dict as a reference ``.pth`` (``module.`` prefixes,
    the ``model`` key): both loaders report nothing missing or unexpected,
    and the weight bridge gives the port's state dict back from the JAX
    variables."""
    model, cfg, _, _, jvars = baseline
    sd = model.state_dict()
    path = str(tmp_path / "baseline.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    zeros = jax.tree_util.tree_map(np.zeros_like, jvars)
    params, stats, report = jax_load_model_variables(path, zeros["params"],
                                                     zeros["batch_stats"])
    assert not report["missing"] and not report["unexpected"], report
    other = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(9))
    report = load_model_variables(path, other)
    assert not report["missing"] and not report["unexpected"], report
    bridged = state_dict_from_jax(jax.device_get(params), jax.device_get(stats))
    assert sorted(bridged) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(bridged[k], v.float()), k
        assert torch.equal(other.state_dict()[k], v), k


def test_baseline_eval_step_with_every_kernel_flag_runs_the_plain_forward(
        baseline, monkeypatch):
    """Every kernel flag on in both packages (the JAX mel kernel in
    interpret mode): the port launches only the log-mel kernel, as the JAX
    step does, and its accumulators are the JAX step's within 2 pixel
    counts (tests/test_torch_port_slice.py's eval limit)."""
    import functools

    from jax.experimental import pallas as pl

    import cavp_tpu_torch.ops.kernels.mel as mel_module

    model, cfg, jmodel, jcfg, jvars = baseline
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    calls = dict.fromkeys(("layer1", "fusion", "argmax", "mel"), 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(loops, "fused_layer1", counted("layer1", loops.fused_layer1))
    monkeypatch.setattr(loops, "fused_visual_fusion", counted("fusion", loops.fused_visual_fusion))
    monkeypatch.setattr(loops, "upsample_argmax", counted("argmax", loops.upsample_argmax))
    monkeypatch.setattr(mel_module, "fused_log_mel", counted("mel", mel_module.fused_log_mel))
    batch = synthetic_eval_batch(cfg, 2, seed=3)
    batch["pix_label"] = np.random.RandomState(4).randint(0, 2, (2, SIZE, SIZE)).astype(np.int32)
    ref = jax.jit(jax_loops.make_eval_step(jmodel, jcfg.replace(**ALL_FLAGS)))(
        jvars, jax_loops.eval_metrics_init(2), {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = loops.make_eval_step(model, cfg.replace(**ALL_FLAGS))(
        loops.eval_metrics_init(2, "cpu"), tbatch)
    assert calls == {"layer1": 0, "fusion": 0, "argmax": 0, "mel": 1}
    for name in ("miou_all", "miou_ms"):
        for f in ("inter", "union", "correct", "labeled"):
            np.testing.assert_allclose(getattr(getattr(got, name), f).numpy(),
                                       np.asarray(getattr(getattr(ref, name), f)),
                                       atol=2, err_msg=f"{name}.{f}")
    np.testing.assert_allclose(got.fg_all.numpy(), np.asarray(ref.fg_all), atol=2)
    assert float(got.miou_all.labeled) == 2 * SIZE * SIZE


# ---------------------------------------------------------------------------
# one train step in both packages
# ---------------------------------------------------------------------------


def _batch(cfg):
    """Blocky binary labels (an ignored corner), and 71-wide one-hot labels
    as the binary setup's items give them: two videos of one class (a
    matched shuffled pair)."""
    batch = synthetic_train_batch(cfg, seed=0)
    lab = np.zeros((BATCH, SIZE, SIZE), np.int32)
    lab[:, SIZE // 4:3 * SIZE // 4, :SIZE // 2] = 1
    lab[1, :, SIZE // 2:] = 1
    lab[0, :6, :6] = 255
    batch["pix_label"] = lab
    img_label = np.zeros((BATCH, 71), np.int32)
    img_label[:, 0] = 1
    for i, c in enumerate((5, 9, 5, 12)):
        img_label[i, c] = 1
    batch["img_label"] = img_label
    batch["shuffle_idx"] = np.array([2, 3, 1, 0], np.int32)
    return batch


def _corocl_scores(B, P, slots):
    """The uniform scores the JAX step draws at step 0 from ``RNG_SEED``
    (tests/test_torch_port_train_step.py ``_draws``)."""
    _, _, k_ctr, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(RNG_SEED), 0), 4)
    return torch.from_numpy(np.stack([np.array(jax.random.uniform(k, (P,)))
                                      for k in jax.random.split(k_ctr, slots + 2)]))


def _one_step(model, cfg, jmodel, jcfg, jvars, variant):
    """(port metrics, JAX metrics, start, port state, JAX state as port
    names) after one step from the same weights on the same batch."""
    batch = _batch(cfg)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=SPE)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jvars["params"],
                           batch_stats=jvars["batch_stats"], opt_state=tx.init(jvars["params"]))
    jstep = jax.jit(jax_loops.make_train_step(jmodel, tx, jcfg, variant=variant))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(RNG_SEED), jnp.int32(0))
    ref = state_dict_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    jm = {k: float(v) for k, v in jm.items()}
    del jstate, jstep, tx
    release_memory()

    m = copy.deepcopy(model)
    opts, _ = make_optimizer(m, cfg, steps_per_epoch=SPE)
    state = create_train_state(m, opts, cfg, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    P = BATCH * (SIZE // 4) ** 2
    tbatch["corocl_scores"] = _corocl_scores(BATCH, P, min(cfg.class_slots, cfg.num_classes))
    state, metrics = loops.make_train_step(m, opts, cfg, variant=variant)(state, tbatch, 0)
    assert state.step == 1
    return {k: float(v) for k, v in metrics.items()}, jm, start, m.state_dict(), ref, cfg.lr


def _check_step(got_m, ref_m, start, got, ref, lr, labels):
    assert set(got_m) == set(ref_m)
    for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av"):
        if k in ref_m:
            np.testing.assert_allclose(got_m[k], ref_m[k], rtol=5e-5, err_msg=k)
    for k in start:
        if k.endswith(("running_mean", "running_var")):
            scale = float(ref[k].abs().max())
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                       atol=1e-4 * scale, err_msg=k)
    limits = {"fusion": (2e-2, 5e-2), "seg_decay": (5e-2, 0.15), "seg_nodecay": (5e-2, 0.15),
              "bkb_decay": (0.12, 0.2), "bkb_nodecay": (0.12, 0.2)}
    by_group = {}
    adam_agree = adam_numel = 0
    for k, g in labels.items():
        dg, dr = got[k] - start[k], ref[k] - start[k]
        if g == "audio":
            assert float(dg.abs().max()) <= lr * (1 + 1e-5), k
            adam_agree += int(((dg - dr).abs() <= 1e-2 * lr).sum())
            adam_numel += dg.numel()
            continue
        if "pos_embed" in k:
            continue
        assert not torch.equal(got[k], start[k]), f"{k} did not move"
        err = float((dg - dr).norm() / (dr.norm() + 1e-30))
        if k.startswith("segment.upsample.classifier"):
            assert err < 5e-3, (k, err)
        by_group.setdefault(g, []).append(err)
    for g, errs in by_group.items():
        median, worst = limits[g]
        assert np.median(errs) < median and max(errs) < worst, (g, np.median(errs), max(errs))
    if adam_numel:
        assert adam_agree >= 0.8 * adam_numel, adam_agree / adam_numel


def test_baseline_train_step_matches_jax(baseline):
    """CE only: the loss is the cross-entropy, the head and backbone groups
    move as the JAX step's, and the model has no Adam (no audio tower)."""
    model, cfg, jmodel, jcfg, jvars = baseline
    got_m, ref_m, start, got, ref, lr = _one_step(model, cfg, jmodel, jcfg, jvars, "baseline")
    assert set(ref_m) == {"loss/loss", "loss/cross_entropy"}
    assert got_m["loss/loss"] == got_m["loss/cross_entropy"]
    labels = label_params(model)
    assert set(labels.values()) == {"seg_decay", "seg_nodecay", "bkb_decay", "bkb_nodecay"}
    assert make_optimizer(model, cfg)[0].adam is None
    _check_step(got_m, ref_m, start, got, ref, lr, labels)


def test_avss_binary_train_step_matches_jax():
    """``CAVP`` at 2 classes with 71-wide one-hot labels, on the module path
    in both packages: CE + CoroCL, no sound bank read or written, every
    group moved as the JAX step's."""
    model, cfg, jmodel, jcfg, jvars = _pair(baseline=False)
    assert cfg.num_classes == 2 and cfg.setup == "avss_binary"
    got_m, ref_m, start, got, ref, lr = _one_step(model, cfg, jmodel, jcfg, jvars, "avss")
    del jvars
    assert got_m["loss/l_ctr_av"] > 0
    _check_step(got_m, ref_m, start, got, ref, lr, label_params(model))
