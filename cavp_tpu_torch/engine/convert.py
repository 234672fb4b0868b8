"""Weight bridge from the JAX package's variables to the port's state dict.

The naming grammar of ``cavp_tpu/engine/convert.py`` inverted, keyed on
``seg_model`` as the JAX package's is: the DeepLabV3Plus names
(``:37-111``), the HRNet-W48 backbone, the HRNet and OCR heads and the
PVT-v2 backbone (the inverse of ``translate_torch_key``, ``:224-260``, as
``enumerate_torch_keys`` gives it, ``:486-514``), with both audio towers
(VGG, and the torchvision ResNet-18 of the VPO setups): flax paths in, the
reference's state-dict names out. Layouts: conv HWIO -> OIHW, dense
[in, out] -> [out, in], BN ``scale``/``bias`` params and ``mean``/``var``
batch stats -> ``weight``/``bias``/``running_mean``/``running_var``.
BatchNorm's ``num_batches_tracked`` (which the JAX package does not
track) is set to 0, so the result loads with ``strict=True``. The baseline
``VisualModel``'s tree is the ``backbone`` and ``segment`` part of the
same grammar, so it converts as it is.

Training adds :func:`named_tensors_from_jax`, which names any tree shaped
like the params (gradients, parameter deltas) the same way and in the
port's layouts, :func:`sound_bank_from_jax`, and
:func:`gradients_by_name` for the port's side of a per-leaf comparison.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# VGG "features" Sequential conv indices for cfg [64,M,128,M,256,256,M,512,512,M]
_VGG_CONV_IDX = (0, 3, 6, 8, 11, 13)
_STEM = {"stem_conv1": "0", "stem_bn1": "1", "stem_conv2": "3",
         "stem_bn2": "4", "stem_conv3": "6"}
_LAST_CONV = {"last_conv0": "0", "last_bn0": "1", "last_conv1": "3",
              "last_bn1": "4"}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, v


_DOWNSAMPLE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _tail(name: str) -> str:
    """A bottleneck's flax child name -> its torch name."""
    return _DOWNSAMPLE.get(name, name)


def _audio_resnet_name(rest: str) -> Optional[str]:
    """``audio_net.net.<rest>`` of the ResNet-18 tower -> its torchvision
    name under ``audio_backbone.backbone``."""
    if rest in ("conv1", "bn1", "fc"):
        return f"audio_backbone.backbone.{rest}"
    m = re.fullmatch(r"layer(\d)_(\d)\.(\w+)", rest)
    if m:
        return f"audio_backbone.backbone.layer{m.group(1)}.{m.group(2)}.{_tail(m.group(3))}"
    return None



def _hrnet_backbone_name(rest: str) -> Optional[str]:
    """``backbone.<rest>`` of the HRNet-W48 backbone -> its torch name."""
    if rest in ("conv1", "bn1", "conv2", "bn2"):
        return f"backbone.{rest}"
    m = re.fullmatch(r"layer1_(\d+)\.(\w+)", rest)
    if m:
        return f"backbone.layer1.{m.group(1)}.{_tail(m.group(2))}"
    m = re.fullmatch(r"transition(\d)_(\d)_(conv|bn)", rest)
    if m:
        t, j, cb = m.groups()
        # the branch a transition opens (j == t) nests one more Sequential
        nest = ".0" if j == t else ""
        return f"backbone.transition{t}.{j}{nest}.{0 if cb == 'conv' else 1}"
    m = re.fullmatch(r"stage(\d)_module(\d+)\.branch(\d)_block(\d+)\.(\w+)", rest)
    if m:
        s, mod, b, k, tail = m.groups()
        return f"backbone.stage{s}.{mod}.branches.{b}.{k}.{tail}"
    m = re.fullmatch(r"stage(\d)_module(\d+)\.fuse(\d)_(\d)_(conv|bn)(\d?)", rest)
    if m:
        s, mod, i, j, cb, k = m.groups()
        hop = f".{k}" if k else ""
        return f"backbone.stage{s}.{mod}.fuse_layers.{i}.{j}{hop}.{0 if cb == 'conv' else 1}"
    return None


def _pvt_backbone_name(rest: str) -> Optional[str]:
    """``backbone.<rest>`` of PVT-v2 -> its torch name."""
    m = re.fullmatch(r"patch_embed(\d)_(proj|norm)", rest)
    if m:
        return f"backbone.patch_embed{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"block(\d)_(\d+)\.([\w.]+)", rest)
    if m:
        tail = "mlp.dwconv.dwconv" if m.group(3) == "mlp.dwconv" else m.group(3)
        return f"backbone.block{m.group(1)}.{m.group(2)}.{tail}"
    if re.fullmatch(r"norm\d", rest):
        return f"backbone.{rest}"
    return None


_OCR_PAIRS = {"conv3x3": "segment.conv3x3",
              "bottleneck": "segment.ocr_distri_head.conv_bn_dropout",
              "aux_conv": "segment.aux_head"}
_OCB = "segment.ocr_distri_head.object_context_block"


def _ocr_segment_name(rest: str) -> Optional[str]:
    """``segment.<rest>`` of the OCR head -> its torch name."""
    m = re.fullmatch(r"(\w+)\.(conv|bn)", rest)
    if m and m.group(1) in _OCR_PAIRS:
        return f"{_OCR_PAIRS[m.group(1)]}.{0 if m.group(2) == 'conv' else 1}"
    m = re.fullmatch(r"attention\.(f_pixel|f_object)_([01])\.(conv|bn)", rest)
    if m:
        which, sub, cb = m.groups()
        return f"{_OCB}.{which}.{3 * int(sub) + (0 if cb == 'conv' else 1)}"
    m = re.fullmatch(r"attention\.(f_down|f_up)\.(conv|bn)", rest)
    if m:
        return f"{_OCB}.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}"
    return {"aux_cls": "segment.aux_head.3", "classifier": "segment.upsample"}.get(rest)


_HRNET_HEAD = {"last_conv": "segment.upsample.last_conv.0",
               "last_bn": "segment.upsample.last_conv.1",
               "classifier": "segment.upsample.classifier"}


def _module_name(path: str, audio_resnet: bool = False,
                 seg_model: str = "DeepLabV3Plus") -> Optional[str]:
    """Flax module path -> torch module name (None: not in the grammar).
    ``audio_resnet``: the audio tower is the ResNet-18 (whose ``conv1``
    would otherwise read as the VGG stack's second conv); ``seg_model``
    picks the backbone's and the head's names."""
    if path.startswith("backbone.") and seg_model in ("HRNet", "OCR"):
        return _hrnet_backbone_name(path[len("backbone."):])
    if path.startswith("backbone.") and seg_model == "PVT":
        return _pvt_backbone_name(path[len("backbone."):])
    if path.startswith("segment.") and seg_model == "HRNet":
        return _HRNET_HEAD.get(path[len("segment."):])
    if path.startswith("segment.") and seg_model == "OCR":
        return _ocr_segment_name(path[len("segment."):])
    if path.startswith("backbone."):
        rest = path[len("backbone."):]
        if rest in _STEM:
            return f"backbone.backbone.conv1.{_STEM[rest]}"
        if rest == "bn1":
            return "backbone.backbone.bn1"
        m = re.fullmatch(r"layer(\d)_(\d+)\.(\w+)", rest)
        if m:
            return f"backbone.backbone.layer{m.group(1)}.{m.group(2)}.{_tail(m.group(3))}"
        return None
    if path.startswith("segment."):
        rest = path[len("segment."):]
        m = re.fullmatch(r"aspp\.map_conv(\d)", rest)
        if m:
            return f"segment.aspp.map_convs.{m.group(1)}"
        if rest.startswith("aspp."):
            return f"segment.{rest}"
        if rest in ("reduce_conv", "reduce_bn"):
            return f"segment.reduce.{0 if rest == 'reduce_conv' else 1}"
        m = re.fullmatch(r"upsample\.(\w+)", rest)
        if m and m.group(1) in _LAST_CONV:
            return f"segment.upsample.last_conv.{_LAST_CONV[m.group(1)]}"
        if rest == "upsample.classifier":
            return "segment.upsample.classifier"
        return None
    if path.startswith("audio_net."):
        rest = path[len("audio_net."):]
        if rest == "cls_head":
            return "audio_backbone.cls_head"
        if audio_resnet:
            return _audio_resnet_name(rest[len("net."):]) if rest.startswith("net.") else None
        m = re.fullmatch(r"net\.conv(\d)", rest)
        if m:
            return f"audio_backbone.backbone.features.{_VGG_CONV_IDX[int(m.group(1))]}"
        m = re.fullmatch(r"net\.fc(\d)", rest)
        if m:
            return f"audio_backbone.backbone.embeddings.{2 * int(m.group(1))}"
        return None
    if path.startswith(("cross_att.", "visual_projector.")):
        return re.sub(r"\.block(\d+)\.", r".blocks.\1.", path)
    return None


def named_tensors_from_jax(tree: Dict[str, Any], dtype=np.float32,
                           seg_model: str = "DeepLabV3Plus") -> Dict[str, torch.Tensor]:
    """A nested dict of arrays under flax paths (params, batch stats,
    or anything shaped like them: gradients, deltas) -> CPU tensors of
    ``dtype`` (float32; float64 for a float64 comparison) under the port's
    state-dict names, in the port's layouts: conv kernels HWIO -> OIHW,
    dense kernels [in, out] -> [out, in].

    Raises ``KeyError`` for a leaf outside ``seg_model``'s grammar, so
    nothing is dropped silently."""
    out: Dict[str, torch.Tensor] = {}
    leaves = list(_flatten(tree))
    audio_resnet = any(p.startswith("audio_net.net.layer") for p, _ in leaves)
    for path, value in leaves:
        value = np.array(value, dtype)  # a writable copy
        if path.startswith("cross_att.pos_embed"):
            out[path] = torch.from_numpy(value)
            continue
        mod, leaf = path.rsplit(".", 1)
        name = _module_name(mod, audio_resnet, seg_model)
        if name is None or leaf not in _LEAF:
            raise KeyError(f"no port name for JAX variable {path!r}")
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        out[f"{name}.{_LEAF[leaf]}"] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def state_dict_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        dtype=np.float32, seg_model: str = "DeepLabV3Plus"
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``variables["params"]`` / ``["batch_stats"]`` (nested dicts of
    arrays) of a CAVP with ``seg_model`` -> the port's state dict (CPU
    tensors of ``dtype``)."""
    out = named_tensors_from_jax(params, dtype, seg_model)
    out.update(named_tensors_from_jax(batch_stats, dtype, seg_model))
    for name in [k for k in out if k.endswith(".running_mean")]:
        out[name[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)
    return out


def sound_bank_from_jax(bank, device="cpu") -> torch.Tensor:
    """The JAX train state's ``sound_bank`` [classes, depth, samples] as
    a float32 tensor."""
    return torch.from_numpy(np.array(bank, np.float32)).to(device)


def gradients_by_name(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: gradient} after a backward pass, zeros where a
    parameter got none (autograd leaves ``None`` for unused ones; the JAX
    package reports zeros)."""
    return {name: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
            for name, p in model.named_parameters()}
