"""The port's ``vpo_mono`` and ``vpo_stereo`` train steps, and the VPO
training entry points' validation, against the JAX package.

One step of each variant in both packages, from one model (deep-stem
ResNet-18 visual tower and the ResNet-18 audio tower, 64x64, 5 classes,
batch 4, float32; TF32 off), on one synthetic batch (3 s of mono or stereo
audio), at epoch 1 from a sound bank filled with the same random waves,
so the overwrite runs and, for ``vpo_mono``, reads the bank. The draws
are injected: the shuffle permutation into both packages, and the uniform
scores the JAX step's keys give (the overwrite's and CoroCL's) into the
port. The JAX step runs its module path; the port runs its module path and
its fusion-kernel path (on the CPU the kernels' plain versions). Both go
from the waveform through their own log-mel frontend.

Checks: the loss terms; the sound bank (``vpo_mono``: equal to the JAX
step's; ``vpo_stereo``: not written); the audio tower's BatchNorm
statistics, which must be those of a tower run on the B unshuffled clips
under ``vpo_stereo`` (the gather convention) and on the 2B matched and
shuffled-or-banked clips under ``vpo_mono``, bit-equal to such a run of
the port's tower and within the first-step limit of the JAX step's; every
parameter delta. Tolerances are
``tests/test_torch_port_train_step.py``'s float32 limits for a first step:
losses rtol 5e-5; BatchNorm statistics 1e-4 of each tensor's largest
entry; parameter deltas per tensor, L2 of the difference over L2 of the
delta: classifier 5e-3, fusion group median 2e-2 / worst 5e-2, head
groups 5e-2 / 0.15, backbone groups 0.12 / 0.2; Adam (the audio tower)
every element at most ``lr`` long (plus the float32 rounding of a
parameter near 1, the tower's BatchNorm weights) and 80% within 1% of
``lr`` of the JAX step's. The port's kernel path against its module path: losses rtol 1e-5,
deltas 2e-3 worst per tensor (the float32 kernel-path limits there).

The validation: each entry point (``main_vpo_mono --setup vpo_ss``,
``main_vpo_stereo --setup vpo_ms``) on a ``make_synthetic_vpo`` tree at
48x48 (neither package has a flag for the image size: the config is cut by
replacing ``flags.get_config``), float32, one epoch of two steps and the
validation at epoch 0; the trained weights then go through the JAX
package's ``run_validation`` on its own VPO test split (PIL path) with the
same collation and batch, both on their module paths: the ten metrics
within 5e-4, about 7 of the 13,824 pixels (measured 3e-9).

The three reports are made once per run, in one process
(``once_per_run``; under xdist started when the module is collected).
"""

import copy
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.data import vpo as jax_vpo
from cavp_tpu.data.pipeline import DataLoader as JaxDataLoader
from cavp_tpu.data.pipeline import collate_eval_frames as jax_collate_eval_frames
from cavp_tpu.data.transforms import VisualAugmentation as JaxVisualAugmentation
from cavp_tpu.engine import loops as jax_loops
from cavp_tpu.engine import runner as jax_runner
from cavp_tpu.engine.convert import import_torch_state_dict
from cavp_tpu.engine.optim import make_optimizer as jax_make_optimizer
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu.engine.state import TrainState as JaxTrainState
from cavp_tpu_torch import main_vpo_mono, main_vpo_stereo
from cavp_tpu_torch.config import flags, get_config
from cavp_tpu_torch.config import setups
from cavp_tpu_torch.data.synthetic import make_synthetic_vpo, synthetic_train_batch
from cavp_tpu_torch.engine import loops, runner
from cavp_tpu_torch.engine.convert import state_dict_from_jax
from cavp_tpu_torch.engine.optim import GROUPS, label_params, make_optimizer
from cavp_tpu_torch.engine.state import create_train_state
from cavp_tpu_torch.models.soundbank import overwrite_from_bank, overwrite_miss_match
from torch_port_common import (  # noqa: F401 (release_after_module is autouse)
    once_per_run,
    release_after_module,
    release_memory,
    start_early,
)
from torch_ref import randomize_bn_stats

SIZE, BATCH, CLASSES, SPE, RNG_SEED = 64, 4, 5, 4, 7
SMALL = dict(image_width=SIZE, image_height=SIZE, num_classes=CLASSES, visual_backbone=18,
             compute_dtype="float32", batch_size=BATCH, max_view=8, class_slots=3, epochs=2)
AUDIO_BN = ("running_mean", "running_var")


def _pair(stereo):
    """(port model, port config, JAX model, JAX config, JAX variables) of
    the vpo_ss setup cut to SMALL, ``in_plane`` 2 for stereo."""
    kw = dict(SMALL, in_plane=2 if stereo else 1)
    cfg, jcfg = get_config("vpo_ss").replace(**kw), jax_get_config("vpo_ss").replace(**kw)
    model = runner.build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    randomize_bn_stats(model, 0)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda r: jmodel.init(
        r, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, cfg.mel_frames, 64, cfg.in_plane)),
        eval_mode=True), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, report = import_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, zeros["params"],
        zeros["batch_stats"])
    assert not report["missing"] and not report["unexpected"], report
    return model, cfg, jmodel, jcfg, {"params": params, "batch_stats": stats}


def _batch(cfg):
    """Blocky labels. Samples 0 and 2 are of class 1 (a matched pair under
    the shuffle [2, 3, 1, 0]), sample 1 is background only, and sample 3
    holds class 2 without the background bit: at this seed's scores the
    overwrite picks it, vpo_mono then takes its shuffled wave from the
    bank, and vpo_stereo's background-only filter (one label bit) drops
    it."""
    batch = synthetic_train_batch(cfg, seed=0)
    lab = np.zeros((BATCH, SIZE, SIZE), np.int32)
    lab[[0, 2], :32, :32] = 1
    lab[0, :8, :8] = 255
    lab[3] = 2
    lab[3, :4, :4] = 255
    batch["pix_label"] = lab
    img_label = np.zeros((BATCH, CLASSES), np.int32)
    img_label[:3, 0] = 1
    img_label[[0, 2], 1] = 1
    img_label[3, 2] = 1
    batch["img_label"] = img_label
    batch["shuffle_idx"] = np.array([2, 3, 1, 0], np.int32)
    return batch


def _overwrites(cfg, batch, ow_scores):
    """The overwrite's pick without and with the background-only filter."""
    idx = torch.from_numpy(batch["shuffle_idx"]).long()
    img_label = torch.from_numpy(batch["img_label"])
    return [overwrite_miss_match((img_label == img_label[idx]).all(1), img_label[idx],
                                 img_label, cfg.ow_rate, scores=ow_scores,
                                 filter_bg_only=f) for f in (False, True)]


def _draws(B, P, slots):
    """The overwrite's and CoroCL's uniform scores of the JAX step at step
    0 from ``RNG_SEED``."""
    _, k_ow, k_ctr, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(RNG_SEED), 0), 4)
    ow = np.array(jax.random.uniform(k_ow, (B,)))
    ctr = np.stack([np.array(jax.random.uniform(k, (P,)))
                    for k in jax.random.split(k_ctr, slots + 2)])
    return torch.from_numpy(ow), torch.from_numpy(ctr)


def _tower_stats(model, cfg, batch, variant, bank, ow_scores):
    """The audio tower's BatchNorm statistics after one train-mode run from
    ``model``'s on the clips the step's convention gives it: the B clips
    (vpo_stereo), or the 2B matched and shuffled clips with the banked
    waves in the overwritten rows (vpo_mono)."""
    m = copy.deepcopy(model).train()
    wave = torch.from_numpy(batch["waveform"])
    if variant == "vpo_mono":
        idx = torch.from_numpy(batch["shuffle_idx"]).long()
        ow, _ = _overwrites(cfg, batch, ow_scores)
        shuffled = overwrite_from_bank(bank, wave[idx].reshape(BATCH, -1), ow.change_mask,
                                       ow.target_class).reshape(wave.shape)
        wave = torch.cat([wave, shuffled])
    mel = loops.preprocess_audio(wave, n_frames=cfg.mel_frames, spec_min=cfg.spec_min,
                                 spec_max=cfg.spec_max)
    with torch.no_grad():
        m.forward_audio_feature(mel.permute(0, 3, 1, 2))
    return {k: v.clone() for k, v in m.state_dict().items()
            if k.startswith("audio_backbone.") and k.endswith(AUDIO_BN)}, wave.shape[0]


def _step_report(variant):
    """One step of ``variant`` in the JAX package and in the port's two
    arms, reduced to what the tests read."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stereo = variant == "vpo_stereo"
    model, cfg, jmodel, jcfg, jvars = _pair(stereo)
    batch = _batch(cfg)
    bank = np.random.RandomState(5).uniform(-0.1, 0.1, (CLASSES, BATCH, cfg.audio_samples)
                                            ).astype(np.float32)
    P = BATCH * (SIZE // 4) ** 2
    ow_scores, ctr_scores = _draws(BATCH, P, cfg.class_slots)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    labels = label_params(model)

    tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=SPE)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jvars["params"],
                           batch_stats=jvars["batch_stats"], opt_state=tx.init(jvars["params"]),
                           sound_bank=jnp.asarray(bank))
    jstep = jax.jit(jax_loops.make_train_step(jmodel, tx, jcfg, variant=variant))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(RNG_SEED), jnp.int32(1))
    ref = state_dict_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
    ref_bank = torch.from_numpy(np.array(jstate.sound_bank))
    ref_m = {k: float(v) for k, v in jm.items()}
    del jstate, jstep, tx, jvars
    release_memory()

    arms = {}
    for arm, fused in (("module", False), ("kernel", True)):
        c = cfg.replace(use_pallas_fusion_train=fused)
        m = copy.deepcopy(model)
        opts, _ = make_optimizer(m, c, steps_per_epoch=SPE)
        state = create_train_state(m, opts, c, "cpu")
        state.sound_bank = torch.from_numpy(bank.copy())
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        b["ow_scores"], b["corocl_scores"] = ow_scores, ctr_scores
        state, metrics = loops.make_train_step(m, opts, c, variant=variant)(state, b, 1)
        assert state.step == 1
        arms[arm] = dict(metrics={k: float(v) for k, v in metrics.items()},
                         state={k: v.detach().clone() for k, v in m.state_dict().items()},
                         bank=state.sound_bank.clone())
        del m, opts, state
    tower, tower_batch = _tower_stats(model, cfg, batch, variant, torch.from_numpy(bank),
                                      ow_scores)
    got = arms["module"]["state"]

    def errors(other):
        out = {}
        for k, g in labels.items():
            if g == "audio" or "pos_embed" in k:
                continue
            dg, dr = got[k] - start[k], other[k] - start[k]
            out[k] = float((dg - dr).norm() / (dr.norm() + 1e-30))
        return out

    # Adam steps at most lr; a step of a parameter near 1 (the tower's
    # BatchNorm weights) is read through that parameter's float32 rounding
    adam = dict(agree=0, numel=0, over=0.0)
    eps = torch.finfo(torch.float32).eps
    for k, g in labels.items():
        if g == "audio":
            dg, dr = got[k] - start[k], ref[k] - start[k]
            adam["agree"] += int(((dg - dr).abs() <= 1e-2 * cfg.lr).sum())
            adam["numel"] += dg.numel()
            adam["over"] = max(adam["over"], float(
                (dg.abs() - cfg.lr - eps * start[k].abs()).max()))
    bn = {k: dict(got=got[k], ref=ref[k], start=start[k]) for k in start
          if k.endswith(AUDIO_BN)}
    return dict(
        lr=cfg.lr, labels=labels, metrics=arms["module"]["metrics"], ref_metrics=ref_m,
        kernel_metrics=arms["kernel"]["metrics"], errors=errors(ref),
        kernel_errors=errors(arms["kernel"]["state"]),
        moved={k: not torch.equal(got[k], start[k]) for k in labels}, adam=adam, bn=bn,
        tower=tower, tower_batch=tower_batch, bank=arms["module"]["bank"],
        picked=[ow.change_mask.tolist() for ow in _overwrites(cfg, batch, ow_scores)],
        kernel_bank=arms["kernel"]["bank"], ref_bank=ref_bank, bank0=torch.from_numpy(bank))


def write_reports(path):
    """Both step reports and the validation report, saved to ``path``:
    what the background job started below runs."""
    reports = {v: _step_report(v) for v in ("vpo_mono", "vpo_stereo")}
    reports["validation"] = _validation_report()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(reports, tmp)
    os.replace(tmp, path)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """The three reports, made once per run in one process. Under xdist
    they are started in the background when this module is collected
    (``start_early`` below): made when their tests come up, they held up
    to three workers for their minute, and the run's later files with
    them."""
    def compute():
        path = tmp_path_factory.mktemp("vpo_reports") / "reports.pt"
        write_reports(path)
        return torch.load(path, weights_only=False)

    return once_per_run("vpo_reports", compute)


start_early("vpo_reports", (
    sys.executable, "-c",
    "import sys; sys.path.insert(0, sys.argv[1]); import conftest; "
    "import test_torch_port_vpo_train as t; t.write_reports(sys.argv[2])",
    os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(params=["vpo_mono", "vpo_stereo"])
def report(request, reports):
    return request.param, reports[request.param]


def test_losses_match_jax(report):
    variant, r = report
    got, ref = r["metrics"], r["ref_metrics"]
    assert set(got) == set(ref)
    for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av"):
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-5, err_msg=k)
        np.testing.assert_allclose(r["kernel_metrics"][k], got[k], rtol=1e-5, err_msg=k)
    assert got["loss/l_ctr_av"] > 0


def test_sound_bank(report):
    """vpo_mono enqueues its single-source waves, as the JAX step does;
    vpo_stereo has no bank and leaves it as it was. The overwrite picked
    sample 3, which the background-only filter drops (vpo_stereo)."""
    variant, r = report
    assert r["picked"] == [[False, False, False, True], [False] * 4]
    assert torch.equal(r["bank"], r["ref_bank"]) and torch.equal(r["kernel_bank"], r["bank"])
    assert torch.equal(r["bank"], r["bank0"]) == (variant == "vpo_stereo")


def test_audio_tower_batch_norm_sees_b_or_2b_clips(report):
    """The audio tower's running statistics are bit-equal to a train-mode
    run of the tower on B clips (vpo_stereo) or 2B (vpo_mono), and within
    the first-step limit of the JAX step's."""
    variant, r = report
    assert r["tower_batch"] == (BATCH if variant == "vpo_stereo" else 2 * BATCH)
    assert r["tower"] and set(r["tower"]) == {k for k in r["bn"] if k.startswith("audio_")}
    for k, want in r["tower"].items():
        assert torch.equal(r["bn"][k]["got"], want), k
    for k, v in r["bn"].items():
        assert not torch.equal(v["got"], v["start"]), f"{k} did not move"
        scale = float(v["ref"].abs().max())
        np.testing.assert_allclose(v["got"].numpy(), v["ref"].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_parameter_deltas_match_jax(report):
    variant, r = report
    labels = r["labels"]
    # every parameter moved but the positional embeddings and the audio
    # classification head, which no forward reads
    still = [k for k, moved in r["moved"].items() if not moved]
    assert all("pos_embed" in k or k.startswith("audio_backbone.cls_head.") for k in still), still
    limits = {"fusion": (2e-2, 5e-2), "seg_decay": (5e-2, 0.15), "seg_nodecay": (5e-2, 0.15),
              "bkb_decay": (0.12, 0.2), "bkb_nodecay": (0.12, 0.2)}
    by_group = {}
    for k, err in r["errors"].items():
        if k.startswith("segment.upsample.classifier"):
            assert err < 5e-3, (k, err)
        by_group.setdefault(labels[k], []).append(err)
    assert set(by_group) == set(GROUPS) - {"audio"}
    for g, errs in by_group.items():
        median, worst = limits[g]
        assert np.median(errs) < median and max(errs) < worst, (g, np.median(errs), max(errs))
    assert max(r["kernel_errors"].values()) < 2e-3
    adam = r["adam"]
    assert adam["numel"] and adam["over"] <= r["lr"] * 1e-5, adam
    assert adam["agree"] >= 0.8 * adam["numel"], adam


# ---------------------------------------------------------------------------
# the validation of each entry point, against the JAX package's
# ---------------------------------------------------------------------------

VAL_SIZE, VAL_CLASSES = 48, 6


def _validation_report():
    """Each entry point run once (one epoch of two steps at batch 4, the
    validation at epoch 0), its validation's metrics and
    loop counts recorded, and the JAX package's ``run_validation`` of the
    trained weights on its own test split."""
    import tempfile

    root = make_synthetic_vpo(tempfile.mkdtemp(prefix="vpo_val_"), num_train=8, num_test=6,
                              image_size=VAL_SIZE)
    small = dict(image_width=VAL_SIZE, image_height=VAL_SIZE, visual_backbone=18,
                 vpo_num_classes=VAL_CLASSES)
    real = dict(get_config=flags.get_config, run_validation=runner.run_validation)
    seen = []

    def run_validation(*a, **kw):
        stats = {}
        res = real["run_validation"](*a, stats=stats, **kw)
        seen.append((res, stats))
        return res

    flags.get_config = lambda setup: setups.get_config(setup).replace(**small)
    runner.run_validation = run_validation
    # the class's own entries: getattr would unwrap the staticmethods
    jax_va = {n: vars(JaxVisualAugmentation)[n] for n in ("native_open_rgb",
                                                          "native_open_index_mask")}
    for n in jax_va:  # the JAX items on their PIL path
        setattr(JaxVisualAugmentation, n, staticmethod(lambda *a, **k: None))
    here = os.getcwd()
    os.chdir(tempfile.mkdtemp(prefix="vpo_ckpt_"))
    out = {}
    try:
        for entry, setup, stereo in ((main_vpo_mono, "vpo_ss", False),
                                     (main_vpo_stereo, "vpo_ms", True)):
            seen.clear()
            argv = ["--setup", setup, "--root_dataset_dir", root, "--epochs", "1",
                    "--batch_size", "4", "--num_workers", "1", "--ignore_ckpt",
                    "--compute_dtype", "float32"]
            stats = {}
            state, best = entry.main(argv, device="cpu", stats=stats)
            (got, vstats), = seen
            cfg = flags.load_args_and_config(argv)
            jcfg = jax_get_config(setup).replace(
                root_dataset_dir=root, batch_size=4, num_classes=VAL_CLASSES,
                in_plane=2 if stereo else 1, compute_dtype="float32",
                **{k: v for k, v in small.items() if k != "vpo_num_classes"})
            jmodel = jax_build_model(jcfg)
            shapes = jax.eval_shape(lambda r: jmodel.init(
                r, jnp.zeros((1, VAL_SIZE, VAL_SIZE, 3)),
                jnp.zeros((1, 300, 64, jcfg.in_plane)), eval_mode=True), jax.random.PRNGKey(0))
            zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
            params, bstats, rep = import_torch_state_dict(
                {k: v.detach().numpy() for k, v in state.model.state_dict().items()},
                zeros["params"], zeros["batch_stats"])
            assert not rep["missing"] and not rep["unexpected"], rep
            rows = pd.read_csv(jax_vpo.select_vpo_csv(jcfg, stereo))
            test = jax_vpo.VPODataset(jcfg, "test", rows, stereo=stereo,
                                      multi_source=setup != "vpo_ss")
            loader = JaxDataLoader(test, jcfg.batch_size, jax_collate_eval_frames,
                                   num_workers=1)
            jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   batch_stats=bstats, opt_state=None)
            ref = jax_runner.run_validation(jcfg, jmodel, jstate, loader)
            out[entry.__name__] = dict(
                got=got, ref={k: float(v) for k, v in ref.items()}, stats=vstats,
                train=stats, steps=state.step, n_test=len(test), best=best,
                num_classes=cfg.num_classes, dtype=state.model.dtype,
                in_plane=state.model.audio_backbone.backbone.conv1.in_channels)
            del state, jmodel, params, bstats, jstate
            release_memory()
    finally:
        os.chdir(here)
        flags.get_config, runner.run_validation = real["get_config"], real["run_validation"]
        for n, fn in jax_va.items():
            setattr(JaxVisualAugmentation, n, fn)
    return out


@pytest.fixture(scope="module")
def validation(reports):
    return reports["validation"]


@pytest.mark.parametrize("entry", ["cavp_tpu_torch.main_vpo_mono",
                                   "cavp_tpu_torch.main_vpo_stereo"])
def test_entry_point_validation_matches_jax(validation, entry):
    r = validation[entry]
    assert r["steps"] == 2 and r["train"]["steps"] == 2
    assert r["num_classes"] == VAL_CLASSES and r["in_plane"] == (2 if "stereo" in entry else 1)
    assert r["dtype"] == torch.float32
    # single frames, batch_size of them a step, every frame valid
    assert r["stats"]["frames"] == r["n_test"] == 6 and r["stats"]["steps"] == 2
    assert set(r["got"]) == set(r["ref"])
    for k, v in r["ref"].items():  # NaN where no frame is multi-source, in both
        np.testing.assert_allclose(r["got"][k], v, rtol=0, atol=5e-4, equal_nan=True,
                                   err_msg=k)
    assert np.isfinite(r["got"]["miou"]) and r["best"] == r["got"]["miou"]


def test_extra_losses_and_unknown_variants_raise():
    cfg = get_config("vpo_ss")
    with pytest.raises(ValueError, match="variant"):
        loops.make_train_step(None, None, cfg, variant="vpo")
    cfg.extra_losses = ["av_contrast"]  # only Config.replace sets them in the JAX package
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        loops.make_train_step(None, None, cfg, variant="vpo_mono")
