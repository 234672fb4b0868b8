"""Per-module parity of the port's models with the JAX package, and the
weight bridge.

Inputs and weights come from numpy and torch seeds and go through both
packages; BatchNorm statistics and LayerNorm affines are moved off
identity so that a misplaced normalization shows. Tolerance (f32):
rtol 2e-4 / atol 2e-5, as tests/test_torch_parity.py, for single layers
and whole towers alike; the full slice's logits are held to the
rtol 1e-3 / atol 1e-3 of the slice tests.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cavp_tpu.engine.convert import export_torch_state_dict
from cavp_tpu.models.layers import BatchNorm, Conv, LayerNorm as JaxLayerNorm
from cavp_tpu_torch.engine.convert import state_dict_from_jax
from cavp_tpu_torch.engine.runner import build_model
from cavp_tpu_torch.models.layers import BatchNorm2d, Conv2d, LayerNorm
from cavp_tpu_torch.models.resnet import RESNET_LAYERS, stage_specs
from torch_port_common import model_pair, release_after_module  # noqa: F401 (autouse)
from torch_ref import TorchCAVP

TOL = dict(rtol=2e-4, atol=2e-5)


def nhwc(x):
    return np.ascontiguousarray(x.permute(0, 2, 3, 1).detach().numpy())


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_conv(stride, dilation):
    torch.manual_seed(0)
    conv = Conv2d(4, 8, 3, stride=stride, padding=dilation, dilation=dilation)
    x = torch.randn(2, 4, 16, 16)
    params = {"params": {
        "kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
        "bias": jnp.asarray(conv.bias.detach().numpy())}}
    ref = Conv(8, 3, strides=stride, padding=dilation, dilation=dilation).apply(
        params, jnp.asarray(nhwc(x)))
    np.testing.assert_allclose(nhwc(conv(x)), np.asarray(ref), **TOL)


def test_batchnorm_eval():
    g = torch.Generator().manual_seed(1)
    bn = BatchNorm2d(6).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) * 1.5 + 0.5)
        bn.weight.copy_(torch.randn(6, generator=g))
        bn.bias.copy_(torch.randn(6, generator=g))
    x = torch.randn(2, 6, 8, 8, generator=g)
    variables = {
        "params": {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()},
        "batch_stats": {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}
    ref = BatchNorm().apply(variables, jnp.asarray(nhwc(x)), True)
    np.testing.assert_allclose(nhwc(bn(x)), np.asarray(ref), **TOL)
    # bf16 activations stay bf16 (the affine itself is computed in f32)
    assert bn(x.bfloat16()).dtype == torch.bfloat16
    # train mode normalizes with the batch's own statistics (held against
    # the JAX module in tests/test_torch_port_train_parts.py)
    y = bn.train()(x)
    np.testing.assert_allclose(y.mean((0, 2, 3)).detach().numpy(), bn.bias.detach().numpy(),
                               rtol=0, atol=1e-5)


def test_layernorm():
    g = torch.Generator().manual_seed(2)
    ln = LayerNorm(12)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.2 * torch.randn(12, generator=g))
        ln.bias.copy_(0.1 * torch.randn(12, generator=g))
    x = torch.randn(3, 5, 12, generator=g) * 3 + 1
    ref = JaxLayerNorm().apply(
        {"params": {"scale": ln.weight.detach().numpy(), "bias": ln.bias.detach().numpy()}},
        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(ln(x).detach().numpy(), np.asarray(ref), **TOL)
    assert ln(x.bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("depth", [18, 50])
def test_stage_specs_and_layer4_surgery(depth):
    """Depth 18 is a Bottleneck net; layer4 always has stride 1 and
    dilations 2, 4, 8, ...; the module schedule follows stage_specs."""
    from cavp_tpu.models.resnet import stage_specs as jax_stage_specs

    rswd = (False, False, False)
    specs = stage_specs(RESNET_LAYERS[depth], rswd)
    assert specs == jax_stage_specs(RESNET_LAYERS[depth], rswd)
    assert [len(s) for s in specs] == list(RESNET_LAYERS[depth])
    assert [b["dilation"] for b in specs[3]] == [2 * 2 ** i for i in range(len(specs[3]))]
    assert all(b["stride"] == 1 for b in specs[3])


@pytest.fixture(scope="module")
def r50():
    """The ResNet-50 model at 64x64 in both packages."""
    return model_pair(seed=0, visual_backbone=50)


def test_resnet50_visual_feature(r50):
    model, cfg, jmodel, _, jvars = r50
    img = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        x = torch.from_numpy(img).permute(0, 3, 1, 2)
        feats = model.backbone(x)
        fea_v = model.forward_visual_feature(x)
    ref_feats = jmodel.apply(jvars, jnp.asarray(img), False,
                             method=lambda m, im, tr: m.backbone(im, tr))
    for got, ref in zip(feats, ref_feats):
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
    ref = jmodel.apply(jvars, jnp.asarray(img), False,
                       method="forward_visual_feature")
    assert fea_v.shape == (2, 304, 16, 16)
    # channels_last: the token reshape the fusion kernel reads is a view
    assert fea_v.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(fea_v), np.asarray(ref), **TOL)


def test_resnet50_slice_forward_matches_jax(r50):
    """The whole eval slice at ResNet-50 width (304-channel fusion), fusion
    kernel path on: logits within rtol 1e-3 / atol 1e-3."""
    from cavp_tpu.engine.loops import make_inference_forward as jax_forward
    from cavp_tpu_torch.engine.loops import make_inference_forward

    model, cfg, jmodel, jcfg, jvars = r50
    rng = np.random.RandomState(7)
    image = rng.randn(2, 64, 64, 3).astype(np.float32)
    audio = rng.randn(2, 96, 64, 1).astype(np.float32)
    ref = np.asarray(jax_forward(jmodel, jcfg.replace(use_pallas_fusion=True))(
        jvars, jnp.asarray(image), jnp.asarray(audio)))
    got = make_inference_forward(model, cfg.replace(use_pallas_fusion=True))(
        torch.from_numpy(image), torch.from_numpy(audio))
    assert got.shape == (2, 64, 64, 5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_deeplabv3plus_head(r50):
    model, _, jmodel, _, jvars = r50
    rng = np.random.RandomState(4)
    f_list = [rng.randn(2, 16, 16, 256), rng.randn(2, 8, 8, 512),
              rng.randn(2, 8, 8, 1024), rng.randn(2, 8, 8, 2048)]
    f_list = [f.astype(np.float32) for f in f_list]
    with torch.no_grad():
        fea = model.segment.forward_feature(
            [torch.from_numpy(f).permute(0, 3, 1, 2) for f in f_list])
        logits = model.segment.upsample(fea)
    ref = jmodel.apply(jvars, [jnp.asarray(f) for f in f_list], False,
                       method=lambda m, f, tr: m.segment.forward_feature(f, tr))
    np.testing.assert_allclose(nhwc(fea), np.asarray(ref), **TOL)
    ref_logits = jmodel.apply(jvars, ref,
                              method=lambda m, f: m.segment.upsample(f, False))
    np.testing.assert_allclose(nhwc(logits), np.asarray(ref_logits), **TOL)


def test_vgg_audio(r50):
    model, _, jmodel, _, jvars = r50
    mel = np.random.RandomState(5).randn(2, 96, 64, 1).astype(np.float32)
    with torch.no_grad():
        got = model.forward_audio_feature(torch.from_numpy(mel).permute(0, 3, 1, 2))
    ref = jmodel.apply(jvars, jnp.asarray(mel), False, method="forward_audio_feature")
    assert got.shape == (2, 304)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bridge_matches_jax_export_and_loads_strictly(r50):
    model, cfg, _, _, jvars = r50
    sd = state_dict_from_jax(jvars["params"], jvars["batch_stats"])
    exported = export_torch_state_dict(jvars["params"], jvars["batch_stats"])
    assert set(sd) - set(exported) == {k for k in sd if k.endswith("num_batches_tracked")}
    assert set(exported) <= set(sd)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert torch.equal(sd[k], v.cpu()), k
    fresh = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(99))
    fresh.load_state_dict(sd, strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_reference_replica_loads_strictly(r50):
    """The reference's module tree (tests/torch_ref.py) and the port
    share every state-dict name, and compute the same logits."""
    model, cfg, _, _, _ = r50
    ref = TorchCAVP(num_classes=cfg.num_classes, visual_backbone=50).eval()
    ref.load_state_dict(model.state_dict(), strict=True)
    rng = np.random.RandomState(6)
    img = torch.from_numpy(rng.randn(1, 3, 64, 64).astype(np.float32))
    mel = torch.from_numpy(rng.randn(1, 1, 96, 64).astype(np.float32))
    with torch.no_grad():
        want, _, _ = ref.forward_inference(img, mel)
        got, _, _ = model(img, mel)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
