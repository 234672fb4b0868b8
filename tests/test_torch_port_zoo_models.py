"""The port's seg-model zoo (``seg_model`` HRNet, OCR and PVT) against the
JAX package and the reference's torch replica.

Full width, every head:

- ``tests/torch_ref_variants.py``'s ``TorchCAVPVariant`` (HRNet-W48, OCR on
  HRNet-W48, PVT-v2 b1) loads into the port's ``CAVP`` with
  ``strict=True``, and the two give the same logits and fused feature
  (64x64, float32, within 1e-5 of the logits' scale);
- a ``.pth`` of each head (the reference's save format) loads through the
  entry points' ``load_model_variables`` into the model ``build_model``
  makes for ``--seg_model`` (PVT: b5, the JAX model's default), nothing
  missing or unexpected, every tensor equal to the file's.

Against the JAX package, float32, 64x64, 5 classes, TF32 off, the JAX side
under ``jax.jit``; HRNet and OCR cut to one module a stage and one
BasicBlock a branch in both packages (``STAGE_MODULES`` and
``BLOCKS_PER_BRANCH``, module constants read at build time; every kind of
branch, transition and fusion path stays, and every naming pattern of the
weight bridge), PVT b1:

- the port's state dict goes through the JAX package's
  ``import_torch_state_dict(..., seg_model=...)`` with nothing missing or
  unexpected, and back through the port's ``state_dict_from_jax(...,
  seg_model=...)`` bit for bit;
- the optimizer groups of every parameter equal the JAX package's
  ``label_params``, leaf by leaf;
- eval logits and fused feature: within 1e-4 of the logits' scale (the
  JAX package's own torch-replica test uses 2e-3);
- HRNet's eval prediction with every kernel flag on (the plain versions of
  the port's kernels; K1 at C = 720 and K4's Pallas kernels in interpret
  mode on the JAX side): the masks equal in at least 99.9% of the pixels,
  and K5's gate leaves the zoo's visual tower alone;
- one train step of HRNet with ``extra_losses = ["av_contrast",
  "pixel_contrast"]``: the channel-dropout mask derived from the JAX step's
  key, CoroCL's and the pixel sampler's draws injected; the loss terms
  within rtol 2e-4, the BatchNorm statistics within 1e-4 of each tensor's
  largest entry, the parameter deltas per tensor (L2 of the difference over
  L2 of the delta) median / worst 5e-2 / 0.2 in the SGD groups (a delta of
  RMS below 1e-7, such as the rounding noise of a conv bias that feeds a
  train-mode BatchNorm: the RMS of its difference below 1e-7), the Adam
  group as in the other port train tests.

The report is made once per run, under xdist in one background process
started at collection (``start_early``); the tests read it.
"""

import contextlib
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.engine import loops as jax_loops
from cavp_tpu.engine.convert import import_torch_state_dict
from cavp_tpu.engine.optim import label_params as jax_label_params
from cavp_tpu.engine.optim import make_optimizer as jax_make_optimizer
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu.engine.state import TrainState as JaxTrainState
from cavp_tpu.models.cavp import CAVP as JaxCAVP
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.engine import loops, runner
from cavp_tpu_torch.engine.checkpoint import load_model_variables
from cavp_tpu_torch.engine.convert import named_tensors_from_jax, state_dict_from_jax
from cavp_tpu_torch.engine.optim import GROUPS, label_params, make_optimizer
from cavp_tpu_torch.engine.state import create_train_state
from cavp_tpu_torch.models.cavp import CAVP
from cavp_tpu_torch.models.layers import init_parameters
from torch_port_common import once_per_run, release_memory, start_early
from torch_ref import randomize_bn_stats

SIZE, BATCH, CLASSES, SPE, RNG_SEED = 64, 4, 5, 4, 11
HEADS = ("HRNet", "OCR", "PVT")
SMALL = dict(image_width=SIZE, image_height=SIZE, num_classes=CLASSES,
             compute_dtype="float32", batch_size=BATCH, max_view=8, class_slots=3)
# a parameter delta of RMS below this is held by the RMS of its difference
# from the JAX step's, not by their ratio: the gradient of a conv bias that
# feeds a train-mode BatchNorm is zero but for rounding noise, and a step of
# weight decay alone is of that size too
NEGLIGIBLE = 1e-7
STEP_LIMITS = {"fusion": (5e-2, 0.2), "seg_decay": (5e-2, 0.2), "seg_nodecay": (5e-2, 0.2),
               "bkb_decay": (5e-2, 0.2), "bkb_nodecay": (5e-2, 0.2)}


@contextlib.contextmanager
def cut_hrnet():
    """HRNet at one module a stage and one BasicBlock a branch, in both
    packages, for what is built (and, for flax, traced) inside."""
    import cavp_tpu.models.hrnet as jh
    import cavp_tpu_torch.models.hrnet as ph

    saved = [(m, n, getattr(m, n)) for m in (jh, ph)
             for n in ("STAGE_MODULES", "BLOCKS_PER_BRANCH")]
    for m in (jh, ph):
        m.STAGE_MODULES, m.BLOCKS_PER_BRANCH = (1, 1, 1), 1
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _port_model(seg, variant="b1", seed=0):
    model = CAVP(num_classes=CLASSES, seg_model=seg, pvt_variant=variant)
    init_parameters(model, torch.Generator().manual_seed(seed))
    randomize_bn_stats(model, seed)
    return model.eval()


def _jax_shapes(jm, size=SIZE):
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, size, size, 3)),
                                              jnp.zeros((1, 96, 64, 1)), eval_mode=True),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _jax_variables(jm, model, seg):
    zeros = _jax_shapes(jm)
    params, stats, report = import_torch_state_dict(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        zeros["params"], zeros["batch_stats"], seg_model=seg)
    return {"params": params, "batch_stats": stats}, report


def _inputs(seed=0, n=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, SIZE, SIZE, 3).astype(np.float32),
            rng.randn(n, 96, 64, 1).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# the report, made in one process
# ---------------------------------------------------------------------------


def _full_width_report(seg):
    """The full-width checks of one head, without JAX: the reference
    replica's state dict loaded strictly and its logits, and a ``.pth`` of
    it through the entry points' loader into the model ``build_model``
    makes for ``--seg_model`` (PVT: b5, so the replica at b1 goes into a
    ``CAVP(pvt_variant="b1")`` and a b5 replica makes the file)."""
    from torch_ref_variants import TorchCAVPVariant

    out = {}
    torch.manual_seed(0)
    ref = TorchCAVPVariant(seg, num_classes=CLASSES, pvt_variant="b1")
    randomize_bn_stats(ref, 1)
    ref.eval()
    cfg = get_config("avss").replace(seg_model=seg, num_classes=CLASSES,
                                     compute_dtype="float32")
    if seg == "PVT":
        model = CAVP(num_classes=CLASSES, seg_model=seg, pvt_variant="b1")
    else:
        model = runner.build_model(cfg, "cpu")
    model.load_state_dict(ref.state_dict(), strict=True)
    img, aud = _inputs(seed=3, n=1)
    with torch.no_grad():
        rl, rf = ref.forward_inference(_nchw(img), _nchw(aud))
        pl, pf, _ = model.eval()(_nchw(img), _nchw(aud))
    out["ref_err"] = (float((pl - rl).abs().max() / rl.abs().max()),
                      float((pf - rf).abs().max() / rf.abs().max()))
    if seg == "PVT":
        ref = TorchCAVPVariant(seg, num_classes=CLASSES, pvt_variant="b5")
        model = runner.build_model(cfg, "cpu")
    path = os.path.join(tempfile.mkdtemp(prefix="zoo_pth_"), f"{seg}.pth")
    torch.save({"model": {"module." + k: v for k, v in ref.state_dict().items()}}, path)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    loaded = load_model_variables(path, model)
    own = model.state_dict()
    out["pth"] = dict(missing=loaded["missing"], unexpected=loaded["unexpected"],
                      converted=len(loaded["converted"]),
                      equal=all(torch.equal(own[k], v) for k, v in ref.state_dict().items()))
    os.remove(path)
    return out


def _bridge_report(seg):
    """The port's state dict through the JAX importer and back through the
    port's bridge, and the optimizer groups against the JAX package's."""
    model = _port_model(seg)
    jm = JaxCAVP(num_classes=CLASSES, seg_model=seg, pvt_variant="b1")
    zeros = _jax_shapes(jm)
    params, stats, rep = import_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, zeros["params"],
        zeros["batch_stats"], seg_model=seg)
    out = {"import": (rep["missing"], rep["unexpected"])}
    back = state_dict_from_jax(params, stats, seg_model=seg)
    own = model.state_dict()
    out["roundtrip"] = (sorted(set(back) ^ set(own)),
                        [k for k in own if not torch.equal(back[k], own[k])])
    labels = jax_label_params(zeros["params"])
    codes = jax.tree_util.tree_map(lambda l: np.array(GROUPS.index(l), np.float32), labels)
    jax_groups = {k: GROUPS[int(v)] for k, v in
                  named_tensors_from_jax(codes, seg_model=seg).items()}
    out["groups"] = (label_params(model), jax_groups)
    return out


def _forward_report(seg):
    """Eval logits and fused feature against the JAX package's."""
    model = _port_model(seg)
    jm = JaxCAVP(num_classes=CLASSES, seg_model=seg, pvt_variant="b1")
    jvars, _ = _jax_variables(jm, model, seg)
    img, aud = _inputs()
    jl, jf = jax.jit(lambda v, i, a: jm.apply(v, i, a, True)[:2])(jvars, img, aud)
    with torch.no_grad():
        pl, pf, _ = model(_nchw(img), _nchw(aud))
    jl, jf = np.asarray(jl).transpose(0, 3, 1, 2), np.asarray(jf).transpose(0, 3, 1, 2)
    return dict(logits=float(np.abs(pl.numpy() - jl).max() / np.abs(jl).max()),
                fused=float(np.abs(pf.numpy() - jf).max() / np.abs(jf).max()),
                shape=tuple(pl.shape), latent=model.latent_dim)


def _eval_report():
    """HRNet's eval prediction with every kernel flag, in both packages."""
    flags = dict(use_pallas_fusion=True, use_pallas_argmax=True, use_pallas_layer1=True,
                 use_pallas_mel=True)
    cfg = get_config("avss").replace(seg_model="HRNet", **SMALL, **flags)
    jcfg = jax_get_config("avss").replace(seg_model="HRNet", **SMALL, **flags)
    model = _port_model("HRNet")
    jm = jax_build_model(jcfg)
    jvars, _ = _jax_variables(jm, model, "HRNet")
    img, aud = _inputs(seed=5)
    ref = np.asarray(jax.jit(jax_loops.make_eval_pred_forward(jm, jcfg))(jvars, img, aud))
    got = loops.make_eval_pred_forward(model, cfg)(torch.from_numpy(img), torch.from_numpy(aud))
    return dict(agree=float((got.numpy() == ref).mean()), shape=tuple(got.shape),
                dtype=str(got.dtype), classes=int(np.unique(ref).size),
                visual_fn=loops._make_visual_feature_fn(model, cfg) == model.forward_visual_feature)


def _batch(cfg):
    """Blocky labels: class 1 covers 48x48 (144 of the 256 feature pixels,
    so it and the background are the pixel sampler's classes) in samples 0
    and 2, class 2 in sample 1, sample 3 is background; the shuffle pairs 0
    with 2."""
    from cavp_tpu_torch.data.synthetic import synthetic_train_batch

    batch = synthetic_train_batch(cfg, seed=0)
    lab = np.zeros((BATCH, SIZE, SIZE), np.int32)
    lab[[0, 2], :48, :48] = 1
    lab[1, 16:, 16:] = 2
    lab[0, :4, :4] = 255
    batch["pix_label"] = lab
    img_label = np.zeros((BATCH, CLASSES), np.int32)
    img_label[:, 0] = 1
    img_label[[0, 2], 1] = 1
    img_label[1, 2] = 1
    batch["img_label"] = img_label
    batch["shuffle_idx"] = np.array([2, 3, 0, 1], np.int32)
    return batch


def _draws(jm, jvars, cfg, B, hw):
    """The JAX step's draws at step 0 from ``RNG_SEED``: the overwrite's and
    CoroCL's uniform scores, the head's channel-dropout keep mask (flax's
    ``dropout`` stream at ``segment/drop``) and the pixel sampler's scores."""
    _, k_ow, k_ctr, k_drop = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(RNG_SEED), 0), 4)
    ow = np.array(jax.random.uniform(k_ow, (B,)))
    ctr = np.stack([np.array(jax.random.uniform(k, (B * hw,)))
                    for k in jax.random.split(k_ctr, cfg.class_slots + 2)])
    kept = jm.apply(jvars, jnp.ones((B, 1, 1, 720)),
                    method=lambda m, x: m.segment.drop(x, deterministic=False),
                    rngs={"dropout": k_drop})
    keys = jax.random.split(jax.random.fold_in(k_ctr, 1), B * 4 * 2)
    px = np.array(jax.vmap(lambda k: jax.random.uniform(k, (hw,)))(keys)).reshape(B, 4, 2, hw)
    return dict(ow_scores=torch.from_numpy(ow), corocl_scores=torch.from_numpy(ctr),
                drop_mask=torch.from_numpy(np.array(kept)[:, 0, 0, :] > 0),
                pixel_contrast_scores=torch.from_numpy(px))


def _step_report():
    """One float32 HRNet train step with both extra losses, in both packages."""
    extra = dict(extra_losses=["av_contrast", "pixel_contrast"])
    cfg = get_config("avss").replace(seg_model="HRNet", **SMALL, **extra)
    jcfg = jax_get_config("avss").replace(seg_model="HRNet", **SMALL, **extra)
    model = _port_model("HRNet")
    jm = jax_build_model(jcfg)
    jvars, _ = _jax_variables(jm, model, "HRNet")
    batch = _batch(cfg)
    hw = (SIZE // 4) ** 2
    draws = _draws(jm, jvars, cfg, BATCH, hw)
    model.train()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    labels = label_params(model)

    opts, _ = make_optimizer(model, cfg, steps_per_epoch=SPE)
    state = create_train_state(model, opts, cfg, "cpu")
    bank0 = state.sound_bank.clone()
    tx, _ = jax_make_optimizer(jcfg, steps_per_epoch=SPE)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jvars["params"],
                           batch_stats=jvars["batch_stats"], opt_state=tx.init(jvars["params"]),
                           sound_bank=jnp.asarray(bank0.numpy()))
    jstep = jax.jit(jax_loops.make_train_step(jm, tx, jcfg))
    jstate, jm_metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(RNG_SEED), jnp.int32(0))
    ref = state_dict_from_jax(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
                              seg_model="HRNet")
    ref_m = {k: float(v) for k, v in jm_metrics.items()}
    del jstate, jstep, tx, jvars
    release_memory()

    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b.update(draws)
    state, metrics = loops.make_train_step(model, opts, cfg)(state, b, 0)
    got = model.state_dict()
    errors, negligible, adam = {}, {}, dict(agree=0, numel=0, over=0.0)
    eps = torch.finfo(torch.float32).eps
    for k, g in labels.items():
        dg, dr = got[k] - start[k], ref[k] - start[k]
        if g == "audio":
            adam["agree"] += int(((dg - dr).abs() <= 1e-2 * cfg.lr).sum())
            adam["numel"] += dg.numel()
            adam["over"] = max(adam["over"], float((dg.abs() - cfg.lr - eps * start[k].abs()).max()))
        elif "pos_embed" not in k:
            rms = float(dr.norm()) / dr.numel() ** 0.5
            if rms < NEGLIGIBLE:  # e.g. a bias before a train-mode BatchNorm
                negligible[k] = (rms, float((dg - dr).norm()) / dg.numel() ** 0.5)
            else:
                errors[k] = float((dg - dr).norm() / (dr.norm() + 1e-30))
    bn = {}
    for k in start:
        if k.endswith(("running_mean", "running_var")):
            bn[k] = (float((got[k] - ref[k]).abs().max() / ref[k].abs().max()),
                     not torch.equal(got[k], start[k]))
    return dict(metrics={k: float(v) for k, v in metrics.items()}, ref_metrics=ref_m,
                errors=errors, negligible=negligible, labels=labels, adam=adam, lr=cfg.lr,
                bn=bn,
                kept=float(draws["drop_mask"].float().mean()),
                moved={k: not torch.equal(got[k], start[k]) for k in labels})


def _report():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"full": {seg: _full_width_report(seg) for seg in HEADS}}
    release_memory()
    with cut_hrnet():
        report["bridge"] = {seg: _bridge_report(seg) for seg in HEADS}
        report["forward"] = {seg: _forward_report(seg) for seg in HEADS}
        release_memory()
        report["eval"] = _eval_report()
        release_memory()
        report["step"] = _step_report()
    return report


def write_report(path):
    """The report, saved to ``path``: what the background job started at
    collection runs (about two minutes of one core; its tests come last in
    the port's files, and every worker that reaches one first waits)."""
    report = _report()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(report, tmp)
    os.replace(tmp, path)


@pytest.fixture(scope="module")
def report():
    return once_per_run("zoo_report", _report)


start_early("zoo_report", (
    sys.executable, "-c",
    "import sys; sys.path.insert(0, sys.argv[1]); import conftest; "
    "import test_torch_port_zoo_models as t; t.write_report(sys.argv[2])",
    os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seg", HEADS)
def test_reference_replica_loads_strictly_and_matches(report, seg):
    logits, fused = report["full"][seg]["ref_err"]
    assert logits < 1e-5 and fused < 1e-5, (logits, fused)


@pytest.mark.parametrize("seg", HEADS)
def test_pth_of_each_head_loads_through_the_entry_points_loader(report, seg):
    r = report["full"][seg]["pth"]
    assert r["missing"] == [] and r["unexpected"] == [] and r["converted"] > 200, r
    assert r["equal"]


@pytest.mark.parametrize("seg", HEADS)
def test_jax_importer_round_trip(report, seg):
    missing, unexpected = report["bridge"][seg]["import"]
    assert missing == [] and unexpected == [], (missing[:10], unexpected[:10])
    names, differ = report["bridge"][seg]["roundtrip"]
    assert names == [] and differ == [], (names[:10], differ[:10])


@pytest.mark.parametrize("seg", HEADS)
def test_optimizer_groups_match_jax(report, seg):
    port, jax_groups = report["bridge"][seg]["groups"]
    assert port == jax_groups
    # PVT's LayerNorm weights and every bias decay-free, its depthwise and
    # sr convs decayed, as flax's kernel / scale / bias leaves say
    if seg == "PVT":
        assert port["backbone.block3.0.norm1.weight"] == "bkb_nodecay"
        assert port["backbone.block3.0.mlp.dwconv.dwconv.weight"] == "bkb_decay"
        assert port["backbone.block1.0.attn.sr.weight"] == "bkb_decay"
        assert port["backbone.block1.0.attn.q.bias"] == "bkb_nodecay"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seg", HEADS)
def test_eval_logits_match_jax(report, seg):
    r = report["forward"][seg]
    assert r["shape"] == (2, CLASSES, SIZE, SIZE)
    assert r["latent"] == {"HRNet": 720, "OCR": 512, "PVT": 112}[seg]
    assert r["logits"] < 1e-4 and r["fused"] < 1e-4, r


def test_eval_prediction_with_every_kernel_flag_matches_jax(report):
    r = report["eval"]
    assert r["shape"] == (2, SIZE, SIZE) and r["dtype"] == "torch.int32"
    assert r["classes"] > 1
    assert r["agree"] >= 0.999, r
    assert r["visual_fn"]  # K5 is for the DeepLabV3+ ResNet tower only


def test_zoo_train_step_with_extra_losses_matches_jax(report):
    r = report["step"]
    got, ref = r["metrics"], r["ref_metrics"]
    assert set(got) == set(ref)
    for k in ("loss/loss", "loss/cross_entropy", "loss/l_ctr_av", "loss/l_av_contrast",
              "loss/l_pixel_contrast"):
        assert got[k] > 0, k
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, err_msg=k)
    assert 0.8 < r["kept"] < 1.0  # Dropout2d(0.1) kept about nine channels in ten
    for k, (err, moved) in r["bn"].items():
        assert err < 1e-4, (k, err)
    assert all(moved for _, moved in r["bn"].values())
    by_group = {}
    for k, err in r["errors"].items():
        by_group.setdefault(r["labels"][k], []).append(err)
    assert set(by_group) == set(GROUPS) - {"audio"}
    for k, (ref_rms, diff_rms) in r["negligible"].items():
        assert diff_rms < NEGLIGIBLE, (k, ref_rms, diff_rms)
    for g, errs in by_group.items():
        median, worst = STEP_LIMITS[g]
        assert np.median(errs) < median and max(errs) < worst, (g, np.median(errs), max(errs))
    still = [k for k, moved in r["moved"].items() if not moved]
    assert all("pos_embed" in k or k.startswith("audio_backbone.cls_head.") for k in still), still
    adam = r["adam"]
    assert adam["numel"] and adam["over"] <= r["lr"] * 1e-5, adam
    assert adam["agree"] >= 0.8 * adam["numel"], adam
