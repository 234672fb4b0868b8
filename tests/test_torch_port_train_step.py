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
- later steps (the trajectories part: by the third step the port's own
  two arms differ by 4% in the loss): losses rtol 0.1, and each SGD
  group's whole three-step delta within 10% in length;
- the port's kernel path against its module path, which share the towers
  bit for bit: first-step losses rtol 1e-5, deltas 2e-3 worst and 1e-4
  median per tensor (measured 5e-5 / 3e-6), later losses rtol 0.1.
"""

import copy

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
from torch_port_common import model_pair

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


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _steps_in_both_packages(overrides=OVERRIDES, epochs=EPOCHS, jax_fused=True,
                             inject_mel=False):
    """The steps in the JAX package and in both arms of the port."""
    model, cfg, jmodel, jcfg, jvars = model_pair(seed=0, **overrides)
    batch = _batch(cfg)
    B = cfg.batch_size
    P = B * (cfg.image_height // 4) * (cfg.image_width // 4)
    start = _snapshot(model)
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
    for epoch in epochs:
        jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(RNG_SEED), jnp.int32(epoch))
        jax_out.append(dict(
            metrics={k: float(v) for k, v in m.items()},
            state=state_dict_from_jax(jax.device_get(jstate.params),
                                      jax.device_get(jstate.batch_stats)),
            bank=sound_bank_from_jax(jstate.sound_bank)))

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
                            state=_snapshot(m), bank=state.sound_bank.clone()))
        assert state.step == len(epochs)
        port_out[arm] = out
    return dict(cfg=cfg, model=model, start=start, jax=jax_out, batch=batch, **port_out)


@pytest.fixture(scope="module")
def runs():
    return _steps_in_both_packages()


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


def test_losses_and_counters_match_jax(runs):
    for i, (got, ref) in enumerate(zip(runs["kernel"], runs["jax"])):
        assert set(got["metrics"]) == set(ref["metrics"])
        for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                       rtol=5e-5 if i == 0 else 0.1, err_msg=f"step {i} {k}")
        for k in ("corocl/eligible_classes", "corocl/dropped_classes", "corocl/anchor_count"):
            assert got["metrics"][k] == ref["metrics"][k], (i, k)
        assert got["metrics"]["loss/l_ctr_av"] > 0
    losses = [o["metrics"]["loss/loss"] for o in runs["kernel"]]
    assert losses[2] < losses[0]


def test_sound_bank_matches_jax_and_feeds_the_overwrite(runs):
    for got, ref in zip(runs["kernel"], runs["jax"]):
        assert torch.equal(got["bank"], ref["bank"])
    bank = runs["kernel"][0]["bank"]
    wave = torch.from_numpy(runs["batch"]["waveform"]).reshape(4, -1)
    # samples 0 and 2 (class 1) and 1 (class 2) are banked in batch order;
    # the multi-source sample 3 is not
    assert torch.equal(bank[1, -2:], wave[[0, 2]]) and torch.equal(bank[2, -1], wave[1])
    assert float(bank[3].abs().sum()) == float(bank[4].abs().sum()) == 0.0


@pytest.mark.parametrize("stat", ["running_mean", "running_var"])
def test_batchnorm_statistics_match_jax(runs, stat):
    names = [k for k in runs["start"] if k.endswith(stat)]
    assert len(names) > 50
    got, ref = runs["kernel"][0]["state"], runs["jax"][0]["state"]
    for k in names:
        scale = float(ref[k].abs().max()) + 1e-12
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
        assert not torch.equal(got[k], runs["start"][k]), k
        assert not torch.equal(runs["kernel"][2]["state"][k], got[k]), k


def test_sgd_parameter_deltas_match_jax_after_one_step(runs):
    labels = label_params(runs["model"])
    errs = _delta_errors(runs["kernel"][0]["state"], runs["jax"][0]["state"],
                         runs["start"], _sgd_names(labels))
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
    for k in errs:
        assert not torch.equal(runs["kernel"][0]["state"][k], runs["start"][k]), k


def test_sgd_group_steps_keep_their_size_over_three_steps(runs):
    """Momentum, the lr lag and the x10 of the head's groups: the length
    of each group's whole three-step delta, which chaos barely moves."""
    labels = label_params(runs["model"])
    norms = {}
    for arm in ("kernel", "jax"):
        for k in _sgd_names(labels):
            d = runs[arm][2]["state"][k] - runs["start"][k]
            key = (arm, labels[k])
            norms[key] = norms.get(key, 0.0) + float(d.double().square().sum())
    for g in {g for _, g in norms}:
        ratio = (norms[("kernel", g)] / norms[("jax", g)]) ** 0.5
        assert 0.9 <= ratio <= 1.1, (g, ratio)


def test_adam_parameter_deltas_match_jax(runs):
    """A first Adam step is ``-lr * sign(g)`` wherever ``|g|`` is far
    above eps: the steps have that size, and their signs agree except
    where the gradient is within the chaos of zero."""
    labels = label_params(runs["model"])
    names = [k for k, g in labels.items() if g == "audio"]
    assert len(names) >= 10
    lr = runs["cfg"].lr
    agree, total = 0, 0
    for k in names:
        dg = runs["kernel"][0]["state"][k] - runs["start"][k]
        dr = runs["jax"][0]["state"][k] - runs["start"][k]
        assert float(dg.abs().max()) <= lr * 1.001 and float(dr.abs().max()) <= lr * 1.001, k
        if k.startswith("audio_backbone.cls_head"):  # built and never used: no gradient
            assert float(dg.abs().max()) == float(dr.abs().max()) == 0.0
            continue
        assert float(dg.abs().max()) >= 0.5 * lr, k
        agree += int(((dg - dr).abs() <= 1e-2 * lr).sum())
        total += dg.numel()
    assert agree / total >= 0.8, agree / total


def test_kernel_path_step_equals_module_path_step(runs):
    """The two arms share the towers bit for bit, so chaos has little to
    grow from: the first step's deltas agree per tensor."""
    labels = label_params(runs["model"])
    for i, (a, b) in enumerate(zip(runs["kernel"], runs["module"])):
        for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av"):
            np.testing.assert_allclose(a["metrics"][k], b["metrics"][k],
                                       rtol=1e-5 if i == 0 else 0.1, err_msg=f"step {i} {k}")
        assert torch.equal(a["bank"], b["bank"])
    errs = _delta_errors(runs["kernel"][0]["state"], runs["module"][0]["state"],
                         runs["start"], _sgd_names(labels))
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
    cfg = get_config("avss")
    for variant in ("baseline", "vpo_mono", "vpo_stereo"):
        with pytest.raises(NotImplementedError, match="P8"):
            loops.make_train_step(None, None, cfg, variant=variant)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg)
