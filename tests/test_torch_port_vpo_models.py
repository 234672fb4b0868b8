"""The VPO setups' models and model state against the JAX package.

- the setups and their command lines: every field of the port's config
  equals the JAX package's for ``vpo_ss``, ``vpo_ms`` and ``vpo_msmi``
  (with ``--use_multi_source``, stored only);
- the ResNet-18 audio tower (``AudioResNet18``) at ``in_plane`` 1 and 2:
  the JAX tower's variables through the weight bridge
  (``state_dict_from_jax``) load strictly into the port's tower, and the
  inline torchvision replica (``tests/torch_ref.TVResNet18``) loads
  strictly from the port's; eval-mode features and a train-mode step's
  features and running statistics against the JAX tower's (float32, on
  300 x 64 log-mels of 3 clips): within 1e-5 of the largest entry;
- the VPO model's whole state dict through the JAX package's importer
  and back;
- ResNet-101 at output stride 8 (dilation ``[False, True, True]``): the
  block schedule equal to the JAX package's, and the c1-c4 features of
  one 64x64 image in eval mode within 1e-4 of the largest entry;
- the sound bank's ``per_label`` rule against ``update_bank`` and its
  sequential loop ``_update_bank_loop``: bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.config import load_args_and_config as jax_load_args_and_config
from cavp_tpu.engine.convert import import_torch_state_dict
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu.models import audio_nets as jax_audio_nets
from cavp_tpu.models import resnet as jax_resnet
from cavp_tpu.models import soundbank as jax_bank
from cavp_tpu_torch.config import Config, load_args_and_config
from cavp_tpu_torch.config.setups import get_config
from cavp_tpu_torch.engine.convert import state_dict_from_jax
from cavp_tpu_torch.engine.runner import build_model
from cavp_tpu_torch.models import audio_nets, resnet, soundbank
from torch_port_common import release_after_module  # noqa: F401 (autouse)
from torch_ref import TVResNet18, randomize_bn_stats


@pytest.mark.parametrize("argv", [
    ["--setup", "vpo_ss"], ["--setup", "vpo_ms", "--batch_size", "8"],
    ["--setup", "vpo_msmi", "--use_multi_source", "--epochs", "3"]],
    ids=["vpo_ss", "vpo_ms", "vpo_msmi"])
def test_vpo_configs_match_jax(argv):
    got, ref = load_args_and_config(argv), jax_load_args_and_config(argv)
    for f in (f for f in Config.__dataclass_fields__ if f != "steps_per_epoch"):
        assert getattr(got, f) == getattr(ref, f), f
    for prop in ("vgg_data_path", "vpo_data_path", "coco_img_root", "coco_mask_root",
                 "mel_frames", "audio_samples"):
        assert getattr(got, prop) == getattr(ref, prop), prop
    assert got.num_classes == 22 and got.mel_frames == 300 and got.audio_backbone == "18"
    base = get_config(argv[1])
    assert base.num_classes == 24 and base.visual_backbone == 101
    assert base.last_three_dilation_stride == [False, True, True]


def _jax_tower(in_plane, out_plane=32):
    """The JAX AudioModel("18") with random variables and moved BatchNorm
    statistics, and the port's tower holding them."""
    jmodel = jax_audio_nets.AudioModel(backbone="18", out_plane=out_plane, in_plane=in_plane,
                                       num_classes=3)
    x = jnp.zeros((1, 300, 64, in_plane))
    v = jmodel.init(jax.random.PRNGKey(in_plane), x, False)
    rng = np.random.RandomState(in_plane)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) + 0.5 if a.ndim else a).astype(np.float32),
        jax.device_get(v["batch_stats"]))
    params = jax.device_get(v["params"])
    sd = state_dict_from_jax({"audio_net": params}, {"audio_net": stats})
    model = audio_nets.AudioModel("18", out_plane, in_plane, num_classes=3)
    model.load_state_dict({k[len("audio_backbone."):]: t for k, t in sd.items()}, strict=True)
    return jmodel, {"params": params, "batch_stats": stats}, model


@pytest.mark.parametrize("in_plane", [1, 2], ids=["mono", "stereo"])
def test_audio_resnet18_matches_jax(in_plane):
    jmodel, jvars, model = _jax_tower(in_plane)
    assert isinstance(model.backbone, audio_nets.AudioResNet18)
    names = set(model.backbone.state_dict())
    assert {"conv1.weight", "bn1.running_var", "layer2.0.downsample.0.weight",
            "layer4.1.bn2.bias", "fc.weight"} <= names
    assert not any(n.startswith("layer1.0.downsample") for n in names)
    tv = TVResNet18(in_plane, 32)
    tv.load_state_dict(model.backbone.state_dict(), strict=True)

    x = np.random.RandomState(5).uniform(-1, 1, (3, 300, 64, in_plane)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, False))(jvars, jnp.asarray(x)))
    model.eval()
    tv.eval()
    with torch.no_grad():
        got, got_tv = model(xt), tv(xt)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got_tv.numpy(), got.numpy(), rtol=0, atol=1e-5 * scale)

    # train mode: batch statistics, and the running ones moved by them
    ref, moved = jax.jit(lambda v, a: jmodel.apply(v, a, True, mutable=["batch_stats"]))(
        jvars, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        got = model(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(ref)).max()))
    stats = state_dict_from_jax({"audio_net": jvars["params"]},
                                {"audio_net": jax.device_get(moved["batch_stats"])})
    n = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            want = stats["audio_backbone." + k]
            np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()), err_msg=k)
            n += 1
    assert n == 2 * 20  # stem + 16 convs of the blocks + 3 downsamples


def test_the_vpo_model_state_round_trips_through_the_jax_importer():
    kw = dict(image_width=64, image_height=64, num_classes=5, visual_backbone=18,
              compute_dtype="float32", in_plane=2)
    cfg, jcfg = get_config("vpo_ms").replace(**kw), jax_get_config("vpo_ms").replace(**kw)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    randomize_bn_stats(model, 1)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, 64, 64, 3)),
                                                  jnp.zeros((1, 300, 64, 2)), eval_mode=True),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = model.state_dict()
    params, stats, report = import_torch_state_dict({k: v.numpy() for k, v in sd.items()},
                                                    zeros["params"], zeros["batch_stats"])
    assert not report["missing"] and not report["unexpected"], report
    back = state_dict_from_jax(params, stats)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float() if v.is_floating_point() else v), k
    assert sum(k.startswith("audio_backbone.backbone.layer") for k in sd) > 0


def test_resnet101_at_output_stride_8_matches_jax():
    dil = (False, True, True)
    specs = resnet.stage_specs(resnet.RESNET_LAYERS[101], dil)
    assert specs == jax_resnet.stage_specs(jax_resnet.RESNET_LAYERS[101], dil)
    assert [len(s) for s in specs] == [3, 4, 23, 3]
    assert specs[2][0] == dict(stride=1, dilation=1, downsample=1)
    assert {b["dilation"] for b in specs[2][1:]} == {2} and specs[3][0]["dilation"] == 2

    cfg = get_config("vpo_ss").replace(image_width=64, image_height=64, num_classes=5,
                                       compute_dtype="float32")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(2))
    randomize_bn_stats(model, 2)
    jmodel = jax_build_model(jax_get_config("vpo_ss").replace(
        image_width=64, image_height=64, num_classes=5, compute_dtype="float32"))
    image = np.random.RandomState(6).randn(1, 64, 64, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, 64, 64, 3)),
                                                  jnp.zeros((1, 300, 64, 1)), eval_mode=True),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, report = import_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, zeros["params"],
        zeros["batch_stats"])
    assert not report["missing"] and not report["unexpected"], report
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, False, method=lambda m, im, tr: m.backbone(
        im, tr)))({"params": params, "batch_stats": stats}, jnp.asarray(image))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(image).permute(0, 3, 1, 2))
    sides = []
    for g, r in zip(got, ref):
        r = np.asarray(r)
        sides.append(r.shape[1])
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))
    assert sides == [16, 8, 8, 8]  # output stride 8 from layer2 on


@pytest.mark.parametrize("B,N", [(8, 3), (12, 2), (5, 8)])
def test_per_label_bank_update_matches_jax_and_the_sequential_loop(B, N):
    """Every source class of every sample enqueues, in batch order (more
    than N into one row keeps the newest N)."""
    rng = np.random.RandomState(B)
    C, D = 6, 5
    bank = rng.randn(C, N, D).astype(np.float32)
    items = rng.randn(B, D).astype(np.float32)
    img_label = (rng.rand(B, C) > 0.5).astype(np.int32)
    img_label[:, 0] = rng.randint(0, 2, B)
    got = soundbank.update_bank(torch.from_numpy(bank), torch.from_numpy(items),
                                torch.from_numpy(img_label), per_label=True).numpy()
    args = (jnp.asarray(bank), jnp.asarray(items), jnp.asarray(img_label))
    np.testing.assert_array_equal(got, np.asarray(jax_bank.update_bank(*args, per_label=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_bank._update_bank_loop(*args,
                                                                           per_label=True)))
    assert not np.array_equal(got, bank)
    if B >= 4 * N:
        assert (img_label[:, 1:].sum(0) > N).any()  # a row took more than N
