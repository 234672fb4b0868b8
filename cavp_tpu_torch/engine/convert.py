"""Weight bridge from the JAX package's variables to the port's state dict.

The DeepLabV3Plus + VGG subset of the naming grammar of
``cavp_tpu/engine/convert.py:37-111``, inverted: flax paths in, the
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


def _module_name(path: str) -> Optional[str]:
    """Flax module path -> torch module name (None: not in the subset)."""
    if path.startswith("backbone."):
        rest = path[len("backbone."):]
        if rest in _STEM:
            return f"backbone.backbone.conv1.{_STEM[rest]}"
        if rest == "bn1":
            return "backbone.backbone.bn1"
        m = re.fullmatch(r"layer(\d)_(\d+)\.(\w+)", rest)
        if m:
            tail = {"downsample_conv": "downsample.0",
                    "downsample_bn": "downsample.1"}.get(m.group(3), m.group(3))
            return f"backbone.backbone.layer{m.group(1)}.{m.group(2)}.{tail}"
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


def named_tensors_from_jax(tree: Dict[str, Any], dtype=np.float32
                           ) -> Dict[str, torch.Tensor]:
    """A nested dict of arrays under flax paths (params, batch stats,
    or anything shaped like them: gradients, deltas) -> CPU tensors of
    ``dtype`` (float32; float64 for a float64 comparison) under the port's
    state-dict names, in the port's layouts: conv kernels HWIO -> OIHW,
    dense kernels [in, out] -> [out, in].

    Raises ``KeyError`` for a leaf outside the DeepLabV3Plus + VGG
    grammar, so nothing is dropped silently."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        value = np.array(value, dtype)  # a writable copy
        if path.startswith("cross_att.pos_embed"):
            out[path] = torch.from_numpy(value)
            continue
        mod, leaf = path.rsplit(".", 1)
        name = _module_name(mod)
        if name is None or leaf not in _LEAF:
            raise KeyError(f"no port name for JAX variable {path!r}")
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        out[f"{name}.{_LEAF[leaf]}"] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def state_dict_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                        dtype=np.float32) -> Dict[str, torch.Tensor]:
    """JAX ``variables["params"]`` / ``["batch_stats"]`` (nested dicts of
    arrays) -> the port's state dict (CPU tensors of ``dtype``)."""
    out = named_tensors_from_jax(params, dtype)
    out.update(named_tensors_from_jax(batch_stats, dtype))
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
