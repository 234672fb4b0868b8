"""The parts of the port's train step against the JAX package, one by one.

Train-mode BatchNorm with its running statistics, the SoundBank functions,
the overwrite of mismatched pairs, CoroCL, cross-entropy, the nearest
label resize, the lr schedule with the optimizer's lr lag, and the
optimizer group of every parameter. Both packages get the same numpy
inputs; where the JAX function draws from a key, the port is handed the
array that key gives (``jax.random.uniform``), which is how the train
step test feeds both packages the same draws.

Tolerances (float32 on the CPU in both packages): integer and boolean
results, the bank and the label resize are exact; BatchNorm output 1e-5
and running statistics 1e-6; losses rtol 1e-5; CoroCL's gradient 1e-5 of
its largest entry; the schedule 5e-7 relative (both compute in float32;
numpy's and XLA's ``pow`` differ by a unit in the last place, 1.2e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.engine import optim as jax_optim
from cavp_tpu.engine.schedules import warmup_poly_schedule as jax_schedule
from cavp_tpu.losses.ce import cross_entropy as jax_cross_entropy
from cavp_tpu.losses.corocl import corocl_loss as jax_corocl_loss
from cavp_tpu.models import soundbank as jax_bank
from cavp_tpu.models.layers import BatchNorm as JaxBatchNorm
from cavp_tpu.ops.interp import interpolate_nearest as jax_interpolate_nearest
from cavp_tpu_torch.engine import optim
from cavp_tpu_torch.engine.convert import named_tensors_from_jax
from cavp_tpu_torch.engine.schedules import warmup_poly_schedule
from cavp_tpu_torch.losses import corocl_loss, cross_entropy
from cavp_tpu_torch.models import soundbank
from cavp_tpu_torch.models.layers import BatchNorm2d
from cavp_tpu_torch.ops.interp import interpolate_nearest
from torch_port_common import model_pair, release_after_module  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# BatchNorm, train mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_matches_jax(dtype):
    """Output, and the running statistics after two batches (biased
    variance normalizes, unbiased goes to the running variance)."""
    rng = np.random.RandomState(0)
    C = 6
    gamma = rng.rand(C).astype(np.float32) + 0.5
    beta = rng.randn(C).astype(np.float32) * 0.1
    mean0 = rng.randn(C).astype(np.float32) * 0.2
    var0 = rng.rand(C).astype(np.float32) + 0.5
    xs = [(rng.randn(3, 5, 4, C) * 2 + 1).astype(np.float32) for _ in range(2)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    jbn = JaxBatchNorm()
    jvars = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
             "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    bn = BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    tol = 1e-5 if dtype == "float32" else 0.07  # bf16: a unit in the last place at |y| ~ 8
    for x in xs:
        ref, mut = jbn.apply(jvars, jnp.asarray(x).astype(jdt), False,
                             mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": mut["batch_stats"]}
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(ref.astype(jnp.float32)), rtol=0, atol=tol)
    stat_tol = 1e-6 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jvars["batch_stats"]["mean"]), rtol=stat_tol, atol=stat_tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(jvars["batch_stats"]["var"]), rtol=stat_tol, atol=stat_tol)
    assert int(bn.num_batches_tracked) == 0
    # eval mode reads what train mode wrote
    bn.eval()
    ref = jbn.apply(jvars, jnp.asarray(xs[0]), True)
    got = bn(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)


def test_train_batchnorm_gradient_matches_jax():
    rng = np.random.RandomState(1)
    C = 4
    x = rng.randn(2, 3, 3, C).astype(np.float32)
    w = rng.randn(2, 3, 3, C).astype(np.float32)
    gamma = rng.rand(C).astype(np.float32) + 0.5
    jbn = JaxBatchNorm()

    def loss(p, xx):
        y, _ = jbn.apply({"params": p, "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}},
                         xx, False, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(w))

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        {"scale": jnp.asarray(gamma), "bias": jnp.zeros(C)}, jnp.asarray(x))
    bn = BatchNorm2d(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    (bn(xt) * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# SoundBank
# ---------------------------------------------------------------------------


def _bank_case(seed, B, C, N, D):
    rng = np.random.RandomState(seed)
    bank = rng.randn(C, N, D).astype(np.float32)
    items = rng.randn(B, D).astype(np.float32)
    img_label = (rng.rand(B, C) < 0.25).astype(np.int32)
    img_label[:, 0] = 1
    # make most rows single-source, some of them into the same class so a
    # row overflows its depth
    for i in range(0, B, 2):
        img_label[i, 1:] = 0
        img_label[i, 1 + (i // 2) % 2] = 1
    return bank, items, img_label


@pytest.mark.parametrize("B,N", [(4, 4), (10, 3), (7, 1)])
def test_update_bank_matches_jax_and_the_sequential_loop(B, N):
    bank, items, img_label = _bank_case(B, B, 5, N, 6)
    got = soundbank.update_bank(torch.from_numpy(bank), torch.from_numpy(items),
                                torch.from_numpy(img_label))
    ref = jax_bank.update_bank(jnp.asarray(bank), jnp.asarray(items), jnp.asarray(img_label))
    loop = jax_bank._update_bank_loop(jnp.asarray(bank), jnp.asarray(items),
                                      jnp.asarray(img_label))
    np.testing.assert_array_equal(got.numpy(), np.asarray(loop))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    cls, single = soundbank.single_source_class(torch.from_numpy(img_label))
    jcls, jsingle = jax_bank.single_source_class(jnp.asarray(img_label))
    np.testing.assert_array_equal(single.numpy(), np.asarray(jsingle))
    np.testing.assert_array_equal(cls.numpy()[np.asarray(jsingle)],
                                  np.asarray(jcls)[np.asarray(jsingle)])
    assert soundbank.init_bank(5, N, 6, "cpu").shape == (5, N, 6)
    # the VPO rule, every source class of a sample (ported with the VPO
    # steps; held on more cases in test_torch_port_vpo_models.py)
    got = soundbank.update_bank(torch.from_numpy(bank), torch.from_numpy(items),
                                torch.from_numpy(img_label), per_label=True)
    loop = jax_bank._update_bank_loop(jnp.asarray(bank), jnp.asarray(items),
                                      jnp.asarray(img_label), per_label=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(loop))


@pytest.mark.parametrize("seed,enabled,filter_bg_only", [(0, True, False), (1, True, True),
                                                         (2, False, False), (3, True, False)])
def test_overwrite_miss_match_matches_jax_on_its_draws(seed, enabled, filter_bg_only):
    rng = np.random.RandomState(seed)
    B, C = 12, 6
    img_label = np.zeros((B, C), np.int32)
    img_label[:, 0] = 1
    for i in range(B):
        img_label[i, 1 + rng.randint(C - 1)] = 1
    img_label[3, 1:] = 1      # a multi-source sample
    img_label[5, 1:] = 0      # a background-only one
    idx = rng.permutation(B)
    shuffle_label = img_label[idx]
    if_match = (img_label == shuffle_label).all(1)
    key = jax.random.PRNGKey(seed)
    ref = jax_bank.overwrite_miss_match(key, jnp.asarray(if_match), jnp.asarray(shuffle_label),
                                        jnp.asarray(img_label), 0.5,
                                        filter_bg_only=filter_bg_only, enabled=enabled)
    scores = torch.from_numpy(np.array(jax.random.uniform(key, (B,))))
    got = soundbank.overwrite_miss_match(
        torch.from_numpy(if_match), torch.from_numpy(shuffle_label),
        torch.from_numpy(img_label), 0.5, scores=scores,
        filter_bg_only=filter_bg_only, enabled=torch.tensor(enabled))
    np.testing.assert_array_equal(got.if_match.numpy(), np.asarray(ref.if_match))
    np.testing.assert_array_equal(got.shuffle_img_label.numpy(), np.asarray(ref.shuffle_img_label))
    np.testing.assert_array_equal(got.change_mask.numpy(), np.asarray(ref.change_mask))
    sel = np.asarray(ref.change_mask)
    np.testing.assert_array_equal(got.target_class.numpy()[sel], np.asarray(ref.target_class)[sel])
    if enabled and seed == 0:
        assert sel.any()
    # the overwrite itself
    bank = rng.randn(C, 3, 7).astype(np.float32)
    shuffled = rng.randn(B, 7).astype(np.float32)
    out = soundbank.overwrite_from_bank(torch.from_numpy(bank), torch.from_numpy(shuffled),
                                        got.change_mask, got.target_class)
    jout = jax_bank.overwrite_from_bank(jnp.asarray(bank), jnp.asarray(shuffled),
                                        ref.change_mask, ref.target_class)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_overwrite_miss_match_draws_from_the_generator():
    img_label = torch.zeros(8, 4, dtype=torch.int32)
    img_label[:, 0] = 1
    img_label[torch.arange(8), 1 + torch.arange(8) % 3] = 1
    shuffle_label = img_label.roll(1, 0)
    if_match = (img_label == shuffle_label).all(1)
    outs = [soundbank.overwrite_miss_match(if_match, shuffle_label, img_label, 0.5,
                                           generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    assert torch.equal(outs[0].change_mask, outs[1].change_mask)
    assert int(outs[0].change_mask.sum()) == int(outs[2].change_mask.sum()) == 4


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_interpolate_nearest_matches_jax_and_torch():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 71, (2, 224, 224)).astype(np.int32)
    for size in [(56, 56), (16, 16), (7, 9), (224, 224), (300, 250)]:
        got = interpolate_nearest(torch.from_numpy(x), size)
        ref = np.asarray(jax_interpolate_nearest(jnp.asarray(x), size))
        np.testing.assert_array_equal(got.numpy(), ref)
        via_torch = torch.nn.functional.interpolate(
            torch.from_numpy(x)[:, None].float(), size=size, mode="nearest")[:, 0]
        np.testing.assert_array_equal(got.numpy(), via_torch.numpy().astype(np.int32))


@pytest.mark.parametrize("case", ["mixed", "all_ignored", "none_ignored"])
def test_cross_entropy_matches_jax(case):
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 8, 8, 5).astype(np.float32) * 3
    labels = rng.randint(0, 5, (2, 8, 8)).astype(np.int32)
    if case == "mixed":
        labels[rng.rand(2, 8, 8) < 0.3] = 255
    elif case == "all_ignored":
        labels[:] = 255
    ref, gref = jax.value_and_grad(jax_cross_entropy)(jnp.asarray(logits), jnp.asarray(labels))
    # the step hands it a channels-first tensor viewed classes-last
    x = torch.from_numpy(logits).permute(0, 3, 1, 2).contiguous().requires_grad_()
    got = cross_entropy(x.permute(0, 2, 3, 1), torch.from_numpy(labels))
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gref),
                               rtol=0, atol=1e-6)
    if case == "all_ignored":
        assert float(got) == 0.0
    bf16 = cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert bf16.dtype == torch.float32


def _corocl_case(seed, B=3, hw=8, C=12, num_classes=6, big=4, drop_bg=False, no_fg=False):
    rng = np.random.RandomState(seed)
    em = rng.randn(B, hw, hw, C).astype(np.float32)
    es = rng.randn(B, hw, hw, C).astype(np.float32)
    gt = rng.randint(0, num_classes, (B, hw * big, hw * big)).astype(np.int32)
    gt[rng.rand(*gt.shape) < 0.05] = 255
    gt[:, :, : hw] = 1   # one class with many pixels, the rest with few
    if drop_bg:
        gt[gt == 0] = 2
    if no_fg:
        gt[:] = 0
    gt_s = np.where(rng.rand(B, 1, 1) < 0.5, gt, 0).astype(np.int32)
    return em, es, gt, gt_s


@pytest.mark.parametrize("seed,max_views,class_slots,kw", [
    (0, 8, 3, {}),                  # more eligible classes than slots
    (1, 16, 8, {}),                 # fewer: empty slots
    (2, 64, 4, {}),                 # one eligible class
    (3, 8, 3, {"drop_bg": True}),   # no background pixel: sample_num 0
    (4, 8, 3, {"no_fg": True}),     # no eligible class: loss 0
])
def test_corocl_matches_jax_on_its_draws(seed, max_views, class_slots, kw):
    num_classes = 6
    em, es, gt, gt_s = _corocl_case(seed, num_classes=num_classes, **kw)
    key = jax.random.PRNGKey(10 + seed)

    def jloss(a, b):
        return jax_corocl_loss(key, a, jnp.asarray(gt), b, jnp.asarray(gt_s),
                               num_classes=num_classes, temperature=0.1,
                               max_views=max_views, class_slots=class_slots)

    (ref, raux), (ga, gb) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(em), jnp.asarray(es))
    slots = min(class_slots, num_classes)
    P = em.shape[0] * em.shape[1] * em.shape[2]
    scores = np.stack([np.asarray(jax.random.uniform(k, (P,)))
                       for k in jax.random.split(key, slots + 2)])
    a = torch.from_numpy(em).requires_grad_()
    b = torch.from_numpy(es).requires_grad_()
    got, aux = corocl_loss(a, torch.from_numpy(gt), b, torch.from_numpy(gt_s),
                           num_classes=num_classes, temperature=0.1, max_views=max_views,
                           class_slots=class_slots, scores=torch.from_numpy(scores))
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-6)
    assert set(aux) == set(raux)
    for k in aux:
        assert int(aux[k]) == int(raux[k]), k
    for g, r in ((a.grad, ga), (b.grad, gb)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * (np.abs(r).max() + 1e-12))
    if kw.get("no_fg"):
        assert float(got) == 0.0 and int(aux["corocl/anchor_count"]) == 0
    elif not kw:
        assert float(got) > 0


def test_corocl_draws_from_the_generator_and_checks_scores():
    em, es, gt, gt_s = _corocl_case(0)
    args = [torch.from_numpy(v) for v in (em, gt, es, gt_s)]
    kw = dict(num_classes=6, max_views=8, class_slots=3)
    a = corocl_loss(*args, generator=torch.Generator().manual_seed(0), **kw)[0]
    b = corocl_loss(*args, generator=torch.Generator().manual_seed(0), **kw)[0]
    c = corocl_loss(*args, generator=torch.Generator().manual_seed(1), **kw)[0]
    assert float(a) == float(b) != float(c)
    with pytest.raises(ValueError, match="scores"):
        corocl_loss(*args, scores=torch.zeros(3, 10), **kw)


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warm", [0, 3])
def test_schedule_and_lr_lag_match_jax(warm):
    """The schedule itself, and the lr each of the first 5 steps runs at:
    step 0 at the constructor's lr, step i at schedule(i - 1)."""
    sched = warmup_poly_schedule(1e-3, 0.9, 40, warm)
    jsched = jax_schedule(1e-3, 0.9, 40, warm)
    for c in [0, 1, 2, 3, 4, 5, 17, 39, 40, 45]:
        np.testing.assert_allclose(sched(c), float(jsched(c)), rtol=5e-7, atol=0, err_msg=str(c))

    # the JAX group's lr at count i is minus its update on a unit gradient
    # with no momentum and no decay
    tx = jax_optim.sgd_group(jsched, 10.0, 0.0, 0.0, base_lr=1e-3)
    p = {"w": jnp.ones(())}
    st = tx.init(p)
    lin = torch.nn.Linear(1, 1, bias=False)
    opts = optim.Optimizers(
        torch.optim.SGD([{"params": lin.parameters(), "lr_multiplier": 10.0}], lr=1e-3),
        torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=1e-3), sched, 1e-3)
    for i in range(5):
        upd, st = tx.update({"w": jnp.ones(())}, st, p)
        lin.weight.grad = torch.ones(1, 1)
        before = float(lin.weight.detach())
        opts.step(i)
        np.testing.assert_allclose(float(lin.weight.detach()) - before, float(upd["w"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(10.0 * opts.lr_at(i), -float(upd["w"]), rtol=1e-6)
    assert opts.lr_at(0) == 1e-3
    lrs = optim.current_lrs(sched, type("C", (), {"lr": 1e-3}), 7)
    jlrs = jax_optim.current_lrs(jsched, type("C", (), {"lr": 1e-3}), 7)
    assert set(lrs) == set(jlrs)
    for k in lrs:
        np.testing.assert_allclose(lrs[k], float(jlrs[k]), rtol=1e-6)


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=0)


def test_group_labels_match_jax_through_the_bridge(pair):
    """Every parameter's optimizer group equals ``label_params`` of the
    JAX tree, name by name through the bridge; BatchNorm and LayerNorm
    affines and all biases sit outside the decay groups of the towers."""
    model, cfg, _, _, jvars = pair
    labels = optim.label_params(model)
    jlabels = jax_optim.label_params(jvars["params"])
    # the bridge names a tree of per-leaf values; carry each label as an index
    order = list(optim.GROUPS)
    as_index = jax.tree_util.tree_map(lambda s: np.full((1, 1, 1, 1), order.index(s), np.float32),
                                      jlabels)
    ref = {k: order[int(v.reshape(-1)[0])]
           for k, v in named_tensors_from_jax(as_index).items()}
    assert set(labels) == set(ref) == {n for n, _ in model.named_parameters()}
    assert labels == ref
    assert set(labels.values()) == set(optim.GROUPS)
    for name, module in model.named_modules():
        if isinstance(module, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
            for leaf in ("weight", "bias"):
                assert not labels[f"{name}.{leaf}"].endswith("_decay"), name


def test_make_optimizer_groups_and_hyperparameters(pair):
    model, cfg, _, _, _ = pair
    opts, sched = optim.make_optimizer(model, cfg.replace(lr=2e-3), steps_per_epoch=7)
    groups = {g["name"]: g for g in opts.sgd.param_groups}
    assert tuple(groups) == optim.SGD_GROUPS
    for name, g in groups.items():
        assert g["momentum"] == 0.9 and g["dampening"] == 0 and not g["nesterov"]
        assert g["weight_decay"] == (0.0 if name.endswith("nodecay") else 1e-4)
        assert g["lr"] == pytest.approx(2e-3 * (10.0 if name.startswith("seg") else 1.0))
        assert g["params"]
    (audio,) = opts.adam.param_groups
    assert audio["lr"] == 2e-3 and audio["betas"] == (0.9, 0.999) and audio["eps"] == 1e-8
    n = sum(len(g["params"]) for g in opts.sgd.param_groups) + len(audio["params"])
    assert n == len(list(model.parameters()))
    assert sched(0) == pytest.approx(2e-3)
