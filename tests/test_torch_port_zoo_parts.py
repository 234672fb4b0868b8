"""The zoo slice's small parts against the JAX package: the auxiliary
losses (``losses/contrast_extra.py``, ``losses/ohem.py``), the
localization evaluators (``metrics/localization.py``), the 2.5-D
convolutions (``models/conv25d.py``) and the heads' channel dropout.

Inputs from numpy seeds, float32; the JAX references under ``jax.jit``.
Tolerances: the losses within rtol 1e-5 (the pixel sampler's draws are the
JAX function's own uniform scores, injected); the evaluators' numbers
equal; the 2.5-D convolutions within 1e-5 (float32 sums in another order).
No model is built here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.losses import contrast_extra as jax_extra
from cavp_tpu.losses.ohem import ohem_cross_entropy as jax_ohem
from cavp_tpu.metrics import localization as jax_loc
from cavp_tpu.models.conv25d import Conv2_5D_depth as JaxDepth
from cavp_tpu.models.conv25d import Conv2_5D_disp as JaxDisp
from cavp_tpu_torch.losses import (
    av_contrast_loss,
    ohem_cross_entropy,
    pixel_contrast_loss,
    supcon_loss,
)
from cavp_tpu_torch.metrics import Evaluator, EvaluatorFull
from cavp_tpu_torch.models.conv25d import Conv2_5D_depth, Conv2_5D_disp
from cavp_tpu_torch.models.hrnet import channel_dropout

RTOL = 1e-5


@pytest.mark.parametrize("with_labels", [True, False])
def test_supcon_loss_matches_jax(with_labels):
    rng = np.random.RandomState(0)
    f = rng.randn(6, 2, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = rng.randint(0, 3, 6) if with_labels else None
    ref = jax.jit(jax_extra.supcon_loss)(jnp.asarray(f), None if lab is None else jnp.asarray(lab))
    got = supcon_loss(torch.from_numpy(f), None if lab is None else torch.from_numpy(lab))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def _labels(B=3, H=32, W=32):
    lab = np.zeros((B, H, W), np.int32)
    lab[0, :16, :16] = 2
    lab[1, 8:, 8:] = 1
    lab[1, :4, :4] = 255
    return lab  # sample 2: background only


def test_av_contrast_loss_matches_jax():
    rng = np.random.RandomState(1)
    B, h, w, C = 3, 16, 16, 8
    fv = rng.randn(B, h * w, C).astype(np.float32)
    fa = rng.randn(B, C).astype(np.float32)
    lab = _labels(B)
    ref = jax.jit(lambda a, b, c: jax_extra.av_contrast_loss(a, b, c, feat_hw=(h, w)))(
        jnp.asarray(fv), jnp.asarray(fa), jnp.asarray(lab))
    got = av_contrast_loss(torch.from_numpy(fv), torch.from_numpy(fa), torch.from_numpy(lab),
                           feat_hw=(h, w))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_pixel_contrast_loss_matches_jax_with_its_draws():
    """The JAX function's keys give the uniform scores of every (image,
    slot, hard/easy) draw; the port takes them as ``scores``."""
    rng = np.random.RandomState(2)
    B, h, w, C, H, W, K, views = 3, 16, 16, 8, 32, 32, 4, 20
    feats = rng.randn(B, h, w, C).astype(np.float32)
    logits = rng.randn(B, H, W, K).astype(np.float32)
    lab = _labels(B, H, W)
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda k, f, l, y: jax_extra.pixel_contrast_loss(k, f, l, y, max_views=views))(
        key, jnp.asarray(feats), jnp.asarray(logits), jnp.asarray(lab))
    keys = jax.random.split(key, B * 4 * 2)
    scores = np.array(jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (h * w,))))(keys))
    got = pixel_contrast_loss(torch.from_numpy(feats), torch.from_numpy(logits),
                              torch.from_numpy(lab), max_views=views,
                              scores=torch.from_numpy(scores.reshape(B, 4, 2, h * w)))
    assert float(got) > 0
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    with pytest.raises(ValueError, match="scores"):
        pixel_contrast_loss(torch.from_numpy(feats), torch.from_numpy(logits),
                            torch.from_numpy(lab), scores=torch.zeros(1, 4, 2, 5))


@pytest.mark.parametrize("min_kept", [0, 16, 100, 5000])
def test_ohem_cross_entropy_matches_jax(min_kept):
    rng = np.random.RandomState(4)
    logits = (2 * rng.randn(2, 16, 16, 5)).astype(np.float32)
    lab = rng.randint(0, 5, (2, 16, 16)).astype(np.int32)
    lab[0, :3] = 255
    ref = jax.jit(lambda a, b: jax_ohem(a, b, min_kept=min_kept))(jnp.asarray(logits),
                                                                    jnp.asarray(lab))
    got = ohem_cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab), min_kept=min_kept)
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def _samples(n=60, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        nb = int(rng.randint(0, 3))
        boxes = [sorted(rng.randint(0, 224, 2)) for _ in range(2 * max(nb, 1))]
        bb = [(boxes[2 * j][0], boxes[2 * j + 1][0], boxes[2 * j][1], boxes[2 * j + 1][1])
              for j in range(max(nb, 1))]
        out.append(dict(name=f"v{i}", bboxes=bb, n=nb, ciou=float(rng.rand()),
                        conf=float(rng.randn()), infer=rng.rand(8, 8),
                        gt=(rng.rand(8, 8) > 0.6).astype(np.float64)))
    return out


def test_evaluator_matches_jax():
    got, ref = Evaluator(), jax_loc.Evaluator()
    for s in _samples():
        for ev in (got, ref):
            ev.cal_CIOU(s["bboxes"], s["conf"], s["infer"], s["gt"], thres=0.5)
    assert got.ciou == ref.ciou and got.area == ref.area and got.score == ref.score
    for name in ("finalize_AUC", "finalize_AP50", "finalize_cIoU"):
        assert getattr(got, name)() == getattr(ref, name)(), name
    got.clear()
    assert got.ciou == []


def test_evaluator_full_matches_jax():
    got, ref = EvaluatorFull(), jax_loc.EvaluatorFull()
    for s in _samples(seed=6):
        area = int(abs((s["bboxes"][0][3] - s["bboxes"][0][1]) * (s["bboxes"][0][2]
                                                                  - s["bboxes"][0][0])))
        for ev in (got, ref):
            ev.update(s["name"], area, s["n"], s["ciou"], s["conf"])
    a, b = got.finalize_stats(), ref.finalize_stats()
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_equal(a[k], b[k], err_msg=k)
    assert got.precision_at_50() == ref.precision_at_50()


@pytest.mark.parametrize("mode", ["depth", "disp"])
def test_conv25d_matches_jax(mode):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 6, 4).astype(np.float32)
    if mode == "depth":
        jmod, port = JaxDepth(features=5), Conv2_5D_depth(4, 5)
        d = (10.0 + rng.randint(-4, 5, (2, 6, 6)) * 0.02).astype(np.float32)
        d[1, 2, 3] = 10.0 + 3 * 0.1  # three grid cells from its neighbours
        cam = {"intrinsic": {"fx": 100.0}}
    else:
        jmod, port = JaxDisp(features=5), Conv2_5D_disp(4, 5)
        d = rng.uniform(5.0, 50.0, (2, 6, 6)).astype(np.float32)
        d[0, 1, 2] = d[1, 4, 4] = 0.0  # invalid disparity
        cam = {"intrinsic": {"fx": 720.0}, "extrinsic": {"baseline": 0.54}}
    assert port.pixel_size == jmod.pixel_size
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(d), cam)
    k = np.array(variables["params"]["kernel"])  # [plane, kh, kw, in, out]
    bias = rng.randn(5).astype(np.float32)
    variables = {"params": {"kernel": k, "bias": bias}}
    ref = np.asarray(jax.jit(lambda v, a, b: jmod.apply(v, a, b, cam))(
        variables, jnp.asarray(x), jnp.asarray(d)))
    with torch.no_grad():
        for p in range(3):
            getattr(port, f"weight_{p}").copy_(torch.from_numpy(k[p].transpose(3, 2, 0, 1)))
        port.bias.copy_(torch.from_numpy(bias))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(d), cam)
    assert sorted(n for n, _ in port.named_parameters()) == ["bias", "weight_0", "weight_1",
                                                              "weight_2"]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)


def test_channel_dropout_takes_its_mask_in_train_mode():
    """Dropout2d with the mask given: identity in eval mode; in train mode
    the kept channels are divided by the keep probability rounded to the
    activations' dtype, the others are zero, and a missing mask raises."""
    x = torch.randn(2, 3, 4, 5)
    assert channel_dropout(x, None, 0.1, training=False) is x
    keep = torch.tensor([[True, False, True], [False, True, True]])
    y = channel_dropout(x, keep, 0.1, training=True)
    torch.testing.assert_close(y[keep], x[keep] / 0.9, rtol=0, atol=0)
    assert bool((y[~keep] == 0).all())
    xb = x.bfloat16()
    yb = channel_dropout(xb, keep, 0.1, training=True)
    assert torch.equal(yb[keep], xb[keep] / float(torch.tensor(0.9, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="keep mask"):
        channel_dropout(x, None, 0.1, training=True)
    with pytest.raises(ValueError, match="does not fit"):
        channel_dropout(x, keep[:1], 0.1, training=True)
