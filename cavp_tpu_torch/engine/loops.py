"""The eval step and its forwards (``cavp_tpu/engine/loops.py``, eval half).

- :func:`make_inference_forward`: logits for the serving path;
- :func:`make_eval_pred_forward`: the int32 argmax mask the metrics read;
- :func:`make_eval_step`: the batched validation step over padded frame
  stacks with a validity mask, MIoU and ForegroundDetect accumulators
  for ALL frames and the multi-source subset carried on the device.

With ``config.use_pallas_fusion`` the fusion stage runs through the
CUDA kernel (:mod:`cavp_tpu_torch.ops.kernels.fusion`) between
``forward_visual_feature``/``forward_audio_feature`` and
``forward_cls``, as the JAX package wires its Pallas kernel. The
upsample and argmax stay plain (the JAX path with
``use_pallas_argmax=False``).

The returned functions take and return the JAX package's layouts:
images [N, H, W, 3], log-mels [N, T, 64, C], logits [N, H, W, classes],
masks [N, H, W] int32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from cavp_tpu_torch.audio.mel import preprocess_audio as _preprocess_nchw
from cavp_tpu_torch.metrics import (
    MIoUState,
    fg_init,
    fg_result,
    fg_update_weighted,
    miou_init,
    miou_result,
    miou_update_weighted,
)
from cavp_tpu_torch.models.cavp import map_to_tokens, tokens_to_map
from cavp_tpu_torch.ops.kernels.fusion import fused_visual_fusion


def preprocess_audio(wave: torch.Tensor, **kw) -> torch.Tensor:
    """Trainer mel: [N, C, L] -> [N, T, 64, C] (the JAX layout)."""
    return _preprocess_nchw(wave, **kw).permute(0, 2, 3, 1)


class EvalMetrics(NamedTuple):
    miou_all: MIoUState
    miou_ms: MIoUState
    fg_all: torch.Tensor
    fg_ms: torch.Tensor


def eval_metrics_init(num_classes: int, device="cpu") -> EvalMetrics:
    return EvalMetrics(miou_all=miou_init(num_classes, device),
                       miou_ms=miou_init(num_classes, device),
                       fg_all=fg_init(num_classes, device),
                       fg_ms=fg_init(num_classes, device))


def eval_metrics_result(m: EvalMetrics) -> Dict[str, torch.Tensor]:
    v_miou, v_acc = miou_result(m.miou_all)
    v_miou_ms, v_acc_ms = miou_result(m.miou_ms)
    fd, f1, f03 = fg_result(m.fg_all)
    fd_ms, f1_ms, f03_ms = fg_result(m.fg_ms)
    return {
        "miou": v_miou, "acc": v_acc, "fdr": fd, "f_1": f1, "f_0.3": f03,
        "miou_ms": v_miou_ms, "acc_ms": v_acc_ms, "fdr_ms": fd_ms,
        "f_1_ms": f1_ms, "f_0.3_ms": f03_ms,
    }


def _multi_source_flag(pix_label: torch.Tensor, thresh: int = 100) -> torch.Tensor:
    """The validation's multi-source gate (trainer_cavp_avss_image.py:449-451),
    per frame: more than 2 label values (bg and ignore included) covering
    more than ``thresh`` pixels each. [N, H, W] -> [N] bool."""
    n = pix_label.shape[0]
    v = pix_label.reshape(n, -1).long().clamp(0, 255)
    idx = v + 256 * torch.arange(n, device=v.device).unsqueeze(1)
    hist = torch.bincount(idx.reshape(-1), minlength=256 * n).reshape(n, 256)
    return (hist > thresh).sum(1) > 2


def make_inference_forward(model, config) -> Callable:
    """Returns fwd(image [N,H,W,3], audio [N,T,64,C]) -> logits [N,H,W,classes]."""
    use_fused = config.use_pallas_fusion

    @torch.inference_mode()
    def fwd(image, audio):
        image = image.permute(0, 3, 1, 2)
        audio = audio.permute(0, 3, 1, 2)
        if not use_fused:
            logits, _, _ = model(image, audio)
            return logits.permute(0, 2, 3, 1)
        fea_v = model.forward_visual_feature(image)
        fea_a = model.forward_audio_feature(audio)
        h, w = fea_v.shape[-2:]
        # CAVP pins its cross-attention at 4 heads
        tokens = fused_visual_fusion(model, map_to_tokens(fea_v), fea_a, num_heads=4)
        logits = model.forward_cls(tokens_to_map(tokens, h, w), image.shape[-2:])
        return logits.permute(0, 2, 3, 1)

    return fwd


def make_eval_pred_forward(model, config) -> Callable:
    """Returns pred_fn(image, audio) -> int32 argmax mask [N, H, W]."""
    fwd = make_inference_forward(model, config)

    def pred_fn(image, audio):
        return fwd(image, audio).argmax(-1).to(torch.int32)

    return pred_fn


def make_eval_step(model, config) -> Callable:
    """Returns eval_step(metrics, batch) -> metrics.

    batch: tensors on the model's device — image [N,H,W,3] float32,
    waveform [N,Ca,L], pix_label [N,H,W], valid [N] (0/1 padding mask).
    """
    pred_fwd = make_eval_pred_forward(model, config)

    @torch.inference_mode()
    def eval_step(metrics: EvalMetrics, batch) -> EvalMetrics:
        audio = preprocess_audio(batch["waveform"], n_frames=config.mel_frames,
                                 spec_min=config.spec_min, spec_max=config.spec_max)
        pix_label = batch["pix_label"]
        valid = batch["valid"].double()
        ms = _multi_source_flag(pix_label).double() * valid
        pred = pred_fwd(batch["image"], audio)
        miou_all, miou_ms = miou_update_weighted(
            (metrics.miou_all, metrics.miou_ms), pred, pix_label, (valid, ms))
        fg_all, fg_ms = fg_update_weighted(
            (metrics.fg_all, metrics.fg_ms), pred, pix_label, (valid, ms))
        return EvalMetrics(miou_all=miou_all, miou_ms=miou_ms,
                           fg_all=fg_all, fg_ms=fg_ms)

    return eval_step
