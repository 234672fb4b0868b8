"""The port's avss train step against the JAX package's, step by step.

One model in both packages (deep-stem ResNet-50 + DeepLabV3+ + VGG, 64x64,
5 classes, batch 4, float32), the same synthetic batch, and the same
draws: the shuffle permutation is injected into both, and the port is
handed the uniform scores that the JAX step's keys give (the overwrite's
``jax.random.uniform(k_ow, (B,))`` and CoroCL's per-group vectors). Both
steps go from the waveform through the mel frontend, the audio dedup and
the sound bank. One step at epoch 0 fills the bank, two at epoch 1 run the
overwrite from it. The JAX step runs with ``use_pallas_fusion_train``
(its Pallas kernels in interpret mode, as tests/test_fusion_train_kernel.py
runs it), the port once through ``fusion_train`` (on the CPU the plain
versions of its kernels, forward and backward) and once through the
modules.

Tolerances. Both packages run in float32, and the tower is chaotic at
this size: with random weights, train-mode BatchNorm over as few as 16
values and ReLUs everywhere, a relative perturbation of 1e-6 of the
*port's own* input image moves its first step's parameter deltas by 1e-2
(L2, per tensor) in the backbone and 2e-3 in the head and the fusion stage
(measured at depth 18; the towers of the two packages differ by about that
much in their float32 rounding). What a wrong composition would show
(a group at the wrong lr, a missing momentum, a lost gradient, BatchNorm
statistics taken from the wrong batch) is an error of order 1. So:

- first step: losses rtol 5e-5 (measured 1.1e-5); BatchNorm statistics
  1e-4 of each tensor's largest entry (measured 3.9e-5); the sound bank
  exact after every step; parameter deltas per tensor as L2 of the
  difference over L2 of the delta: classifier 5e-3 (measured 5.5e-4),
  fusion group median 2e-2 / worst 5e-2 (measured 2.8e-3 / 6.5e-3), head
  groups 5e-2 / 0.15 (1.4e-2 / 3.3e-2), backbone groups 0.12 / 0.2
  (4.0e-2 / 5.4e-2);
- Adam (audio tower): every step at most ``lr`` long and 80% of the
  elements equal within 1% of ``lr`` (the rest have gradients within the
  chaos of zero, where the sign decides);
- later steps: by the third float32 step the port's own two arms differ
  by 4% in the loss, so float32 says nothing there. They are compared in
  float64 instead (tests/_torch_port_train_fp64.py, a subprocess: the same
  three steps at depth 18 in both packages on the module path). The two
  quantities the JAX package keeps float32 under x64 (its interpolation
  weights and its learning rate) are levelled there, and the report says
  so; after that what is left is float64 rounding grown by the tower:
  losses rtol 1e-8 (measured 1.3e-12 at the third step), counters equal,
  each parameter's whole delta within 1e-6 after every step (measured
  5.3e-12, 1.6e-11, 1.4e-10; with either quantity left float32 the third
  step reads 8.8e-4), BatchNorm statistics 1e-8 (3.2e-12), each group's
  three-step delta length within 1e-6 (measured below 1e-10), the sound
  banks equal;
- the port's kernel path against its module path, which share the towers
  bit for bit: first-step losses rtol 1e-5, deltas 2e-3 worst and 1e-4
  median per tensor (measured 5e-5 / 3e-6), later losses rtol 0.1.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.engine import loops as jax_loops
from cavp_tpu.engine.optim import make_optimizer as jax_make_optimizer
from cavp_tpu.engine.state import TrainState as JaxTrainState
from cavp_tpu.models.soundbank import init_bank as jax_init_bank
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.data.synthetic import synthetic_train_batch
from cavp_tpu_torch.engine import loops
from cavp_tpu_torch.engine.convert import (
    sound_bank_from_jax,
    state_dict_from_jax,
)
from cavp_tpu_torch.engine.optim import label_params, make_optimizer
from cavp_tpu_torch.engine.runner import init_state
from cavp_tpu_torch.engine.state import create_train_state
from torch_port_common import (  # noqa: F401 (release_after_module is autouse)
    configs,
    model_pair,
    once_per_run,
    release_after_module,
    release_memory,
    start_early,
)

SPE = 4          # steps per epoch of the schedule
EPOCHS = (0, 1, 1)
RNG_SEED = 7
OVERRIDES = dict(visual_backbone=50, batch_size=4, max_view=8, class_slots=3,
                 epochs=2)


def _batch(cfg):
    """Blocky labels, so classes stay eligible after the nearest resize,
    two samples of one class (a matched shuffled pair) and one
    multi-source sample (never banked, never overwritten)."""
    batch = synthetic_train_batch(cfg, seed=0)
    lab = batch["pix_label"]
    lab[:, :32, :32], lab[:, 32:, :32], lab[:, :, 32:] = 1, 2, 0
    lab[0, :8, :8] = 255
    lab[1, :, 32:] = 3
    batch["img_label"][:] = 0
    batch["img_label"][:, 0] = 1
    for i, classes in enumerate([(1,), (2,), (1,), (3, 4)]):
        batch["img_label"][i, list(classes)] = 1
    batch["shuffle_idx"] = np.array([2, 3, 1, 0], np.int32)
    return batch


def _draws(step, B, P, slots):
    """The uniform scores the JAX step draws at ``step`` from ``RNG_SEED``."""
    _, k_ow, k_ctr, _ = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(RNG_SEED), step), 4)
    ow = np.array(jax.random.uniform(k_ow, (B,)))
    ctr = np.stack([np.array(jax.random.uniform(k, (P,)))
                    for k in jax.random.split(k_ctr, slots + 2)])
    return torch.from_numpy(ow), torch.from_numpy(ctr)


def _kept(state, step=0):
    """What is kept of the state after a step: all of it after the first,
    the BatchNorm statistics after the later ones (all that is read)."""
    return {k: v.detach().clone() for k, v in state.items()
            if step == 0 or k.endswith(("running_mean", "running_var"))}


def _snapshot(model, step=0):
    return _kept(model.state_dict(), step)


def _steps_in_both_packages(overrides=OVERRIDES, epochs=EPOCHS, jax_fused=True,
                             inject_mel=False):
    """The steps in the JAX package and in both arms of the port."""
    model, cfg, jmodel, jcfg, jvars = model_pair(seed=0, **overrides)
    batch = _batch(cfg)
    B = cfg.batch_size
    P = B * (cfg.image_height // 4) * (cfg.image_width // 4)
    start = _snapshot(model)
    labels = label_params(model)
    if inject_mel:
        wave = jnp.asarray(batch["waveform"])
        batch["mel"] = np.array(jax_loops.preprocess_audio(
            jnp.concatenate([wave, wave[batch["shuffle_idx"]]]), n_frames=cfg.mel_frames,
            spec_min=cfg.spec_min, spec_max=cfg.spec_max))

    # --- JAX ---
    jcfg = jcfg.replace(use_pallas_fusion_train=jax_fused)
    tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=SPE)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=jvars["params"],
        batch_stats=jvars["batch_stats"], opt_state=tx.init(jvars["params"]),
        sound_bank=jax_init_bank(jcfg.num_classes, B, jcfg.audio_samples))
    jstep = jax.jit(jax_loops.make_train_step(jmodel, tx, jcfg, variant="avss"))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_out = []
    for i, epoch in enumerate(epochs):
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(RNG_SEED), jnp.int32(epoch))
        jax_out.append(dict(
            metrics={k: float(v) for k, v in m.items()},
            state=_kept(state_dict_from_jax(jax.device_get(jstate.params),
                                            jax.device_get(jstate.batch_stats)), i),
            bank=sound_bank_from_jax(jstate.sound_bank)))
    # a ResNet-50 state with its optimizer is gigabytes: drop the JAX side
    # before the port's arms run
    del jstate, jstep, jbatch, jvars, tx, m
    release_memory()

    # --- the port, kernel path and module path ---
    port_out = {}
    for arm, fused in (("kernel", True), ("module", False)):
        c = cfg.replace(use_pallas_fusion_train=fused)
        m = copy.deepcopy(model)
        opts, _ = make_optimizer(m, c, steps_per_epoch=SPE)
        state = create_train_state(m, opts, c, "cpu")
        step = loops.make_train_step(m, opts, c)
        out = []
        for i, epoch in enumerate(epochs):
            ow, ctr = _draws(i, B, P, c.class_slots)
            b = {k: torch.from_numpy(v) for k, v in batch.items()}
            b["ow_scores"], b["corocl_scores"] = ow, ctr
            state, metrics = step(state, b, epoch)
            out.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                            state=_snapshot(m, i), bank=state.sound_bank.clone()))
        assert state.step == len(epochs)
        port_out[arm] = out
        del m, opts, state, step
        release_memory()
    return dict(cfg=cfg, labels=labels, start=start, jax=jax_out, batch=batch, **port_out)


def _report():
    """The steps in both packages, reduced to what the tests read: the
    metrics, each tensor's delta error, whether it moved, the BatchNorm
    statistics, the first bank. Small (a few MB) where the states are
    gigabytes, so that it can be shared between the workers."""
    r = _steps_in_both_packages()
    labels, start, lr = r["labels"], r["start"], r["cfg"].lr
    arms = ("kernel", "jax", "module")
    k0, j0, m0 = (r[arm][0]["state"] for arm in arms)
    sgd = _sgd_names(labels)
    adam = {}
    for k in (k for k, g in labels.items() if g == "audio"):
        dg, dr = k0[k] - start[k], j0[k] - start[k]
        adam[k] = dict(max_port=float(dg.abs().max()), max_jax=float(dr.abs().max()),
                       agree=int(((dg - dr).abs() <= 1e-2 * lr).sum()), numel=dg.numel())
    return dict(
        lr=lr, labels=labels,
        metrics={arm: [o["metrics"] for o in r[arm]] for arm in arms},
        banks_equal={arm: [bool(torch.equal(a["bank"], b["bank"]))
                           for a, b in zip(r["kernel"], r[arm])] for arm in ("jax", "module")},
        bank0=r["kernel"][0]["bank"],
        bn={k: dict(start=start[k], got=k0[k], ref=j0[k], later=r["kernel"][2]["state"][k])
            for k in start if k.endswith(("running_mean", "running_var"))},
        sgd_errs=_delta_errors(k0, j0, start, sgd),
        sgd_moved={k: not torch.equal(k0[k], start[k]) for k in sgd},
        adam=adam,
        module_errs=_delta_errors(k0, m0, start, sgd))


def write_f32_report(path):
    """The float32 report, made in a subprocess, saved to ``path``: what
    one of the background jobs started below runs."""
    f32 = f"{path}.f32"
    runs = _f32_report(f32)
    os.unlink(f32)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(runs, tmp)
    os.replace(tmp, path)


def write_fp64_report(path):
    """The float64 report, saved to ``path``: what the other runs."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_fp64_report(), tmp)
    os.replace(tmp, path)


def _f32_report(path):
    """:func:`_report` in a fresh interpreter, with this suite's JAX
    settings (``conftest``), saved to ``path`` and loaded here: the heap it
    grows goes with the process."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import conftest, torch; "
            "import test_torch_port_train_step as t; torch.save(t._report(), sys.argv[2])")
    out = subprocess.run([sys.executable, "-c", code, tests, str(path)],
                         cwd=os.path.dirname(tests), capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return torch.load(path, weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The float32 report, made once per run in a subprocess (5-9 GB while
    it is made). Under xdist it and the float64 report are started side by
    side in the background when this module is collected
    (``torch_port_common.start_early`` below), so that they are done before
    the JAX package's float64 drivers run; made one after the other, the
    workers that reach this module's tests first waited for both."""
    return once_per_run("train_step_f32", lambda: _f32_report(
        tmp_path_factory.mktemp("train_step_f32") / "runs.pt"))


for _name, _writer in (("train_step_f32", "write_f32_report"),
                       ("train_step_fp64", "write_fp64_report")):
    start_early(_name, (
        sys.executable, "-c",
        "import sys; sys.path.insert(0, sys.argv[1]); import conftest; "
        f"import test_torch_port_train_step as t; t.{_writer}(sys.argv[2])",
        os.path.dirname(os.path.abspath(__file__))))


def _fp64_report():
    """Run the float64 script and parse its one JSON line."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(tests, "_torch_port_train_fp64.py")],
                         cwd=os.path.dirname(tests), env=env, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fp64():
    report = once_per_run("train_step_fp64", _fp64_report)
    assert report["dtype"] == "torch.float64" and report["jax_dtype"] == "float64"
    assert report["epochs"] == list(EPOCHS)
    # the levelling took effect: the float64 weights were the ones called,
    # the JAX lr is float32 and the port's schedule rounds onto it
    assert report["interp_patch_calls"] > 0
    assert report["jax_lr_dtype"] == "float32" and report["lr_equal"]
    return report


def _delta_errors(got, ref, start, names):
    """{name: L2 of the difference of the two parameter deltas over the
    L2 of the reference delta}."""
    out = {}
    for k in names:
        dg, dr = got[k] - start[k], ref[k] - start[k]
        out[k] = float((dg - dr).norm() / (dr.norm() + 1e-30))
    return out


def _sgd_names(labels):
    return [k for k, g in labels.items() if g != "audio" and "pos_embed" not in k]


def _by_group(errs, labels):
    out = {}
    for k, e in errs.items():
        out.setdefault(labels[k], []).append(e)
    return {g: (float(np.median(v)), max(v)) for g, v in out.items()}


LOSSES = ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av")
COUNTERS = ("corocl/eligible_classes", "corocl/dropped_classes", "corocl/anchor_count")


def test_losses_and_counters_match_jax(runs, fp64):
    """The first step in float32, through the kernel path; every step in
    float64."""
    got, ref = runs["metrics"]["kernel"][0], runs["metrics"]["jax"][0]
    assert set(got) == set(ref)
    for k in LOSSES:
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-5, err_msg=k)
    for k in COUNTERS:
        assert got[k] == ref[k], k
    assert got["loss/l_ctr_av"] > 0
    for i, (got, ref) in enumerate(zip(fp64["port"], fp64["jax"])):
        for k in LOSSES:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-8, err_msg=f"step {i} {k}")
        for k in COUNTERS:
            assert got[k] == ref[k], (i, k)
        assert got["loss/l_ctr_av"] > 0 and got["corocl/eligible_classes"] >= 1
    losses = [m["loss/loss"] for m in fp64["port"]]
    assert losses[2] < losses[1] < losses[0]


def test_sound_bank_matches_jax_and_feeds_the_overwrite(runs):
    assert runs["banks_equal"]["jax"] == [True] * len(EPOCHS)
    bank = runs["bank0"]
    wave = torch.from_numpy(_batch(configs(**OVERRIDES)[0])["waveform"]).reshape(4, -1)
    # samples 0 and 2 (class 1) and 1 (class 2) are banked in batch order;
    # the multi-source sample 3 is not
    assert torch.equal(bank[1, -2:], wave[[0, 2]]) and torch.equal(bank[2, -1], wave[1])
    assert float(bank[3].abs().sum()) == float(bank[4].abs().sum()) == 0.0


@pytest.mark.parametrize("stat", ["running_mean", "running_var"])
def test_batchnorm_statistics_match_jax(runs, stat):
    names = [k for k in runs["bn"] if k.endswith(stat)]
    assert len(names) > 50
    for k in names:
        bn = runs["bn"][k]
        scale = float(bn["ref"].abs().max()) + 1e-12
        np.testing.assert_allclose(bn["got"].numpy(), bn["ref"].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
        assert not torch.equal(bn["got"], bn["start"]), k
        assert not torch.equal(bn["later"], bn["got"]), k


def test_sgd_parameter_deltas_match_jax_after_one_step(runs):
    labels, errs = runs["labels"], runs["sgd_errs"]
    assert set(errs) == set(_sgd_names(labels))
    groups = _by_group(errs, labels)
    assert set(groups) == {"seg_decay", "seg_nodecay", "bkb_decay", "bkb_nodecay", "fusion"}
    # the classifier lies behind no BatchNorm on the way back
    assert errs["segment.upsample.classifier.weight"] <= 5e-3, errs
    assert errs["segment.upsample.classifier.bias"] <= 5e-3
    limits = {"fusion": (2e-2, 5e-2), "seg_decay": (5e-2, 0.15), "seg_nodecay": (5e-2, 0.15),
              "bkb_decay": (0.12, 0.2), "bkb_nodecay": (0.12, 0.2)}
    for g, (median, worst) in groups.items():
        assert median <= limits[g][0] and worst <= limits[g][1], groups
    # every tensor of every group moved
    assert all(runs["sgd_moved"].values()), [k for k, m in runs["sgd_moved"].items() if not m]


def test_sgd_group_steps_keep_their_size_over_three_steps(fp64):
    """Momentum, the lr lag and the x10 of the head's groups, in float64:
    every parameter's whole delta after each step, and the length of each
    group's three-step delta."""
    groups = {"seg_decay", "seg_nodecay", "bkb_decay", "bkb_nodecay", "fusion", "audio"}
    assert len(fp64["steps"]) == len(EPOCHS)
    for i, step in enumerate(fp64["steps"]):
        assert set(step["delta_err_by_group"]) == groups and step["n_params"] >= 150
        for g, err in step["delta_err_by_group"].items():
            assert err <= 1e-6, (i, g, err, step["worst_delta"])
        assert step["n_bn"] > 50 and step["worst_bn"][0][1] <= 1e-8, (i, step["worst_bn"])
        assert step["bank_equal"], i
    for g, norm in fp64["steps"][2]["group_delta_norm"].items():
        assert norm["jax"] > 0 and abs(norm["port"] / norm["jax"] - 1.0) <= 1e-6, (g, norm)


def test_adam_parameter_deltas_match_jax(runs):
    """A first Adam step is ``-lr * sign(g)`` wherever ``|g|`` is far
    above eps: the steps have that size, and their signs agree except
    where the gradient is within the chaos of zero."""
    adam, lr = runs["adam"], runs["lr"]
    assert len(adam) >= 10
    agree, total = 0, 0
    for k, a in adam.items():
        assert a["max_port"] <= lr * 1.001 and a["max_jax"] <= lr * 1.001, k
        if k.startswith("audio_backbone.cls_head"):  # built and never used: no gradient
            assert a["max_port"] == a["max_jax"] == 0.0
            continue
        assert a["max_port"] >= 0.5 * lr, k
        agree += a["agree"]   # elements equal within 1% of lr
        total += a["numel"]
    assert agree / total >= 0.8, agree / total


def test_kernel_path_step_equals_module_path_step(runs):
    """The two arms share the towers bit for bit, so chaos has little to
    grow from: the first step's deltas agree per tensor."""
    for i, (a, b) in enumerate(zip(runs["metrics"]["kernel"], runs["metrics"]["module"])):
        for k in LOSSES:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5 if i == 0 else 0.1,
                                       err_msg=f"step {i} {k}")
    assert runs["banks_equal"]["module"] == [True] * len(EPOCHS)
    errs = runs["module_errs"]
    assert max(errs.values()) <= 2e-3, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert float(np.median(list(errs.values()))) <= 1e-4


SMALL18 = dict(image_width=64, image_height=64, num_classes=5, visual_backbone=18,
               compute_dtype="float32", batch_size=4, max_view=8, class_slots=3, epochs=2)


def test_injected_mel_equals_the_dedup_path_and_the_generator_draws():
    """The 2B mel convention (``batch["mel"]``) against the deduplicated
    tower on the waveform, at epoch 0 where nothing is overwritten; and a
    step with no injected draw takes them from the state's generator."""
    cfg = get_config("avss").replace(**SMALL18)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    losses = []
    for inject in (False, True):
        state = init_state(cfg, "cpu", steps_per_epoch=SPE)
        step = loops.make_train_step(state.model, state.optimizers, cfg)
        b = dict(batch)
        if inject:
            wave = b["waveform"]
            b["mel"] = loops.preprocess_audio(
                torch.cat([wave, wave[b["shuffle_idx"].long()]]), n_frames=cfg.mel_frames,
                spec_min=cfg.spec_min, spec_max=cfg.spec_max)
        state, m = step(state, b, 0)
        losses.append(float(m["loss/loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)

    # no injected draw at all: two states from one seed agree, at epoch 1
    outs = []
    for _ in range(2):
        state = init_state(cfg, "cpu", steps_per_epoch=SPE)
        step = loops.make_train_step(state.model, state.optimizers, cfg)
        b = {k: v for k, v in batch.items() if k != "shuffle_idx"}
        state, m = step(state, b, torch.tensor(1))
        outs.append(float(m["loss/loss"]))
    assert outs[0] == outs[1] and np.isfinite(outs[0])


def test_unported_variants_and_the_default_device_raise():
    """Every variant of the JAX package is ported: the vpo steps
    (tests/test_torch_port_vpo_train.py holds them against the JAX
    package) and the baseline step (tests/test_torch_port_baseline.py)
    give steps, an unknown variant raises; and so does the default device
    without a card."""
    cfg = get_config("avss")
    for variant in ("vpo_mono", "vpo_stereo", "baseline"):
        assert callable(loops.make_train_step(None, None, cfg, variant=variant))
    with pytest.raises(ValueError, match="variant"):
        loops.make_train_step(None, None, cfg, variant="vpo")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg)


def test_train_step_copies_no_host_array_and_sizes_nothing_from_the_data(monkeypatch):
    """After its first call (which fills the caches), the train step makes
    no tensor from host memory and calls no ``torch.bincount``, with its
    draws from the generator, the overwrite
    live (epoch 1, as an int and as a tensor) and either fusion path: on
    the card each of these makes the host wait for the device, so the loop
    could not run ahead. The nearest label resize once uploaded its index
    tables on every call, CoroCL sized its class histogram from the data,
    and the overwrite's epoch gate was uploaded every step. (Reads on the
    host cannot be told apart here, where every tensor is one: Adam reads
    its step counts, which lie on the host on the card too;
    ``chip_smoke.py`` counts the syncs on the card.)"""
    cfg = get_config("avss").replace(**SMALL18)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items() if k != "shuffle_idx"}
    state = init_state(cfg, "cpu", steps_per_epoch=SPE)
    arms = [(loops.make_train_step(state.model, state.optimizers, cfg.replace(**flags)), epoch)
            for flags, epoch in (({}, 1), ({"use_pallas_fusion_train": True}, torch.tensor(1)))]
    for step, epoch in arms:
        state, _ = step(state, batch, epoch)
    for arm, (step, epoch) in enumerate(arms):
        made = []
        for name in ("from_numpy", "tensor", "as_tensor", "bincount"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, lambda *a, _real=real, _name=name, **kw:
                                made.append(_name) or _real(*a, **kw))
        state, metrics = step(state, batch, epoch)
        monkeypatch.undo()
        assert made == [], (arm, made)
    assert np.isfinite(float(metrics["loss/loss"])) and state.step == 4
