"""The train step, the eval step and its forwards
(``cavp_tpu/engine/loops.py``).

- :func:`make_train_step`: the avss, vpo_mono and vpo_stereo train steps:
  the CoroCL batch construction (shuffle, overwrite-miss-match, SoundBank
  FIFO, matched and shuffled audio over one visual batch), CE + CoroCL,
  backward, and the multi-group SGD/Adam update; with
  ``variant="baseline"`` the ``--use_baseline`` step (``VisualModel``, CE
  only);
- :func:`make_inference_forward`: logits for the serving path;
- :func:`make_eval_pred_forward`: the int32 argmax mask the metrics read;
- :func:`make_eval_step`: the batched validation step over padded frame
  stacks with a validity mask, MIoU and ForegroundDetect accumulators
  for ALL frames and the multi-source subset carried on the device;
- :func:`make_jf_test_step`: the AVSBench-Object (S4 / MS3) J&F test
  step, per video.

With ``config.use_pallas_fusion`` the eval fusion stage runs through the
CUDA kernel (:mod:`cavp_tpu_torch.ops.kernels.fusion`) between
``forward_visual_feature``/``forward_audio_feature`` and
``forward_cls``, as the JAX package wires its Pallas kernel; with
``config.use_pallas_fusion_train`` the train step's does, forward and
backward (:mod:`cavp_tpu_torch.ops.kernels.fusion_train`). Three more
eval-side flags follow the JAX package's: ``use_pallas_mel`` (the log-mel
frontend, :mod:`cavp_tpu_torch.ops.kernels.mel`, in the eval and the train
step), ``use_pallas_layer1`` (ResNet layer1,
:mod:`cavp_tpu_torch.ops.kernels.layer1`) and, inside the
``use_pallas_fusion`` branch of the eval step, ``use_pallas_argmax`` (the
logit upsample and the argmax,
:mod:`cavp_tpu_torch.ops.kernels.upsample_argmax`). The eval flags wire
their kernels in between the decomposed methods, so, as in the JAX
package, they act only on a model that has them (:func:`_decomposable`):
the baseline ``VisualModel`` runs its plain forward whatever the flags.
The J&F step runs the plain forward and the plain log-mel, as the JAX
package's does.

The returned functions take and return the JAX package's layouts:
images [N, H, W, 3], log-mels [N, T, 64, C], logits [N, H, W, classes],
masks [N, H, W] int32.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from cavp_tpu_torch.audio.mel import preprocess_audio as _preprocess_nchw
from cavp_tpu_torch.metrics import (
    MIoUState,
    counts,
    eval_fmeasure,
    fg_init,
    fg_result,
    fg_update_weighted,
    mask_iou,
    miou_init,
    miou_result,
    miou_update_weighted,
)
from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.state import TrainState
from cavp_tpu_torch.losses import (
    av_contrast_loss,
    corocl_loss,
    cross_entropy,
    pixel_contrast_loss,
)
from cavp_tpu_torch.models.cavp import map_to_tokens, tokens_to_map
from cavp_tpu_torch.models.soundbank import (
    overwrite_from_bank,
    overwrite_miss_match,
    update_bank,
)
from cavp_tpu_torch.ops.interp import interpolate_bilinear_separable
from cavp_tpu_torch.ops.kernels.fusion import fused_visual_fusion
from cavp_tpu_torch.ops.kernels.fusion_train import fusion_train
from cavp_tpu_torch.ops.kernels.layer1 import fused_layer1
from cavp_tpu_torch.ops.kernels.upsample_argmax import upsample_argmax


def preprocess_audio(wave: torch.Tensor, **kw) -> torch.Tensor:
    """Trainer mel: [N, C, L] -> [N, T, 64, C] (the JAX layout)."""
    return _preprocess_nchw(wave, **kw).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def make_train_step(model, optimizers, config, *, variant: str = "avss") -> Callable:
    """Returns train_step(state, batch, epoch) -> (state, metrics).

    batch: tensors on the model's device: image [B,H,W,3] (normalized),
    waveform [B,Ca,L], pix_label [B,H,W] int, img_label [B,classes] int
    multi-hot. ``epoch`` (int or 0-dim tensor) gates the overwrite: it is
    live from epoch 1 on, decided inside the step.

    The state is updated in place (module, optimizers) and returned with
    the new step count and sound bank. ``metrics`` are 0-dim tensors under
    the JAX package's keys; nothing in the step waits for the device.

    A test can fix every draw through the batch: ``shuffle_idx`` [B], the
    uniform scores ``ow_scores`` [B] of the overwrite and
    ``corocl_scores`` [class_slots + 2, B*h*w] of the CoroCL sampler, and
    a precomputed ``mel`` ([2B,T,64,Ca], matched then shuffled; [B,...]
    for ``vpo_stereo``). Without them the draws come from
    ``state.generator``.

    The HRNet and OCR heads drop whole channels in train mode: their keep
    mask (``CAVP.channel_dropout``: [B, width]) is ``batch["drop_mask"]``
    or a draw from the generator. ``config.extra_losses`` adds
    ``"av_contrast"`` and ``"pixel_contrast"`` at weight ``config.loss_w``
    (metrics ``loss/l_av_contrast``, ``loss/l_pixel_contrast``); the pixel
    sampler's draws are ``batch["pixel_contrast_scores"]`` [B, 4, 2, h*w]
    or the generator's.

    ``variant``: ``"avss"``; ``"vpo_mono"`` (the wave bank and the
    overwrite, the tower on the 2B clips); ``"vpo_stereo"`` (the overwrite
    of the labels only, without the background-only samples, no bank, the
    tower on the B clips and the shuffled half a feature gather);
    ``"baseline"``, the ``--use_baseline`` step
    (:func:`_make_baseline_train_step`).
    """
    if variant == "baseline":
        return _make_baseline_train_step(model, optimizers)
    if variant not in ("avss", "vpo_mono", "vpo_stereo"):
        raise ValueError(f"unknown train-step variant {variant!r}")
    extra = tuple(getattr(config, "extra_losses", ()) or ())
    unknown = set(extra) - {"av_contrast", "pixel_contrast"}
    if unknown:
        raise ValueError(f"unknown extra_losses {sorted(unknown)}")
    n_frames = config.mel_frames
    plain_avss = config.avsbench_split == "all" and config.setup != "avss_binary"
    # the wave bank: avss (but for the binary and single-subset runs) and
    # vpo_mono; the overwrite: those and vpo_stereo, which keeps only the
    # label side of it and drops the background-only samples
    use_wave_bank = variant == "vpo_mono" or (variant == "avss" and plain_avss)
    use_overwrite = variant != "avss" or plain_avss
    filter_bg_only = variant == "vpo_stereo"
    # vpo_stereo's audio convention (trainer_cavp_vpo_stereo.py:211): the
    # tower runs on the B unshuffled clips and the shuffled half is the
    # feature gather fea_a[shuffle_idx], so its train-mode BatchNorm sees B
    # clips; the others run it on the 2B matched and shuffled clips
    gather_audio = variant == "vpo_stereo"
    use_fused_fusion = (config.use_pallas_fusion_train
                        and getattr(model, "seg_model", "") == "DeepLabV3Plus")
    dedup_audio = variant == "avss" and config.audio_backbone == "vgg" and config.audio_dedup
    dropout = getattr(model, "channel_dropout", None)

    def train_step(state: TrainState, batch, epoch) -> Tuple[TrainState, Dict]:
        if state.model is not model or state.optimizers is not optimizers:
            raise ValueError("the state belongs to another model or optimizer")
        image = batch["image"]
        waveform = batch["waveform"]
        pix_label = batch["pix_label"]
        img_label = batch["img_label"]
        B = image.shape[0]
        dev = image.device
        gen = state.generator
        # a bool for an int epoch, a 0-dim tensor for a tensor one: made
        # without a copy to the device
        ow_flag = epoch >= 1

        # --- shuffle batch construction ---
        if "shuffle_idx" in batch:
            shuffle_idx = batch["shuffle_idx"].long()
        else:
            shuffle_idx = torch.randperm(B, generator=gen, device=dev)
        shuffle_img_label = img_label[shuffle_idx]
        if_match = (img_label == shuffle_img_label).all(dim=1)
        shuffle_wave = waveform[shuffle_idx]

        sound_bank = state.sound_bank
        sound_bank_pre = sound_bank  # the overwrite reads the pre-update bank
        change_mask = torch.zeros(B, dtype=torch.bool, device=dev)
        target_class = torch.zeros(B, dtype=torch.long, device=dev)
        if use_overwrite:
            ow = overwrite_miss_match(if_match, shuffle_img_label, img_label,
                                      config.ow_rate, scores=batch.get("ow_scores"),
                                      generator=gen, filter_bg_only=filter_bg_only,
                                      enabled=ow_flag)
            if_match = ow.if_match
            if use_wave_bank:
                change_mask = ow.change_mask & ow_flag
                target_class = ow.target_class
                shuffle_wave = overwrite_from_bank(
                    sound_bank, shuffle_wave.reshape(B, -1), change_mask,
                    target_class).reshape(shuffle_wave.shape)
        if use_wave_bank:
            sound_bank = update_bank(sound_bank, waveform.reshape(B, -1), img_label)

        # --- the audio batch. The VGG tower is per clip (no BatchNorm) and
        # the shuffled half is a permutation of the matched one except for
        # the at most floor(B*ow_rate) bank-overwritten rows: the tower
        # runs on B + K clips and the shuffled half is a feature gather.
        audio_gather_idx = shuffle_idx if gather_audio else None
        if "mel" in batch:
            # [B, ...] under the gather convention, else [2B, ...]
            audio = batch["mel"]
        else:
            if gather_audio:
                input_wave = waveform
            elif dedup_audio:
                K = (min(B, int(B * config.ow_rate))
                     if (use_overwrite and use_wave_bank) else 0)
                if K > 0:
                    # changed rows first, in batch order; slot j holds the
                    # j-th overwritten row's bank waveform
                    slots = torch.sort((~change_mask).long(), stable=True).indices[:K]
                    bank_wave = sound_bank_pre[target_class[slots], 0]
                    input_wave = torch.cat(
                        [waveform, bank_wave.reshape((K,) + tuple(waveform.shape[1:]))])
                    rank = change_mask.long().cumsum(0) - 1
                    audio_gather_idx = torch.where(change_mask, B + rank.clamp(0, K - 1),
                                                   shuffle_idx)
                else:
                    input_wave = waveform
                    audio_gather_idx = shuffle_idx
            else:
                input_wave = torch.cat([waveform, shuffle_wave])
            audio = preprocess_audio(input_wave, n_frames=n_frames,
                                     spec_min=config.spec_min, spec_max=config.spec_max,
                                     use_pallas=config.use_pallas_mel)

        # the shuffled pair's ground truth: the matched one where it matches
        gt_shuffle = torch.where(if_match[:, None, None], pix_label,
                                 torch.zeros_like(pix_label))

        # the head's channel-dropout keep mask (HRNet, OCR)
        drop_mask = None
        if dropout is not None:
            site, rate, width = dropout
            rows = B if site == "feature" or model.cls_matched_only else 2 * B
            drop_mask = batch.get("drop_mask")
            if drop_mask is None:
                drop_mask = torch.rand(rows, width, generator=gen, device=dev) < 1.0 - rate

        # --- forward (NCHW inside) ---
        optimizers.zero_grad()
        model.train()
        image_nchw = image.permute(0, 3, 1, 2)
        audio_nchw = audio.permute(0, 3, 1, 2)
        if use_fused_fusion:
            fea_v = model.forward_visual_feature(image_nchw)
            fea_a = model.forward_audio_feature(audio_nchw)
            if audio_gather_idx is not None:
                fea_a = torch.cat([fea_a[:B], fea_a[audio_gather_idx]], dim=0)
            h, w = fea_v.shape[-2:]
            # CAVP pins its cross-attention at 4 heads
            tokens = fusion_train(model, map_to_tokens(fea_v), fea_a, num_heads=4)
            fused2b = tokens_to_map(tokens, h, w)
            head_in = fused2b[:B] if model.cls_matched_only else fused2b
            logits2b = model.forward_cls(head_in, image_nchw.shape[-2:])
        else:
            logits2b, fused2b, pack = model(image_nchw, audio_nchw, eval_mode=False,
                                            audio_gather_idx=audio_gather_idx,
                                            drop_mask=drop_mask)
            fea_a = pack["audio"]
        output = logits2b[:B].permute(0, 2, 3, 1)
        embeds = fused2b.permute(0, 2, 3, 1)  # [2B, h, w, C], a view
        l_ce = cross_entropy(output, pix_label)
        l_ctr, aux = corocl_loss(
            embeds[:B], pix_label, embeds[B:], gt_shuffle,
            num_classes=config.num_classes, temperature=config.cl_temp,
            max_views=config.max_view, class_slots=config.class_slots,
            scores=batch.get("corocl_scores"), generator=gen)
        loss = l_ce + config.corocl_w * l_ctr
        # the reference Losser's dormant objectives, weighted by loss_w
        if "av_contrast" in extra:
            h, w = embeds.shape[1:3]
            l_av = av_contrast_loss(embeds[:B].reshape(B, h * w, -1), fea_a[:B], pix_label,
                                    temperature=config.cl_temp, feat_hw=(h, w))
            loss = loss + config.loss_w * l_av
            aux = {**aux, "loss/l_av_contrast": l_av.detach()}
        if "pixel_contrast" in extra:
            l_px = pixel_contrast_loss(embeds[:B], output, pix_label,
                                       temperature=config.cl_temp,
                                       scores=batch.get("pixel_contrast_scores"),
                                       generator=gen)
            loss = loss + config.loss_w * l_px
            aux = {**aux, "loss/l_pixel_contrast": l_px.detach()}

        # --- backward and both optimizers ---
        loss.backward()
        optimizers.step(state.step)

        state.step += 1
        state.sound_bank = sound_bank
        metrics = {"loss/loss": loss.detach(), "loss/cross_entropy": l_ce.detach(),
                   "loss/l_ctr_av": l_ctr.detach(), **aux}
        return state, metrics

    return train_step


def _make_baseline_train_step(model, optimizers) -> Callable:
    """``--use_baseline`` (main_avss_resize.py:92-104): the visual-only
    ``VisualModel`` and the cross-entropy alone: no shuffled batch, no
    sound bank, no contrastive term. The same signature and state as the
    avss step; ``batch`` needs ``image`` and ``pix_label`` only."""

    def train_step(state: TrainState, batch, epoch) -> Tuple[TrainState, Dict]:
        del epoch
        if state.model is not model or state.optimizers is not optimizers:
            raise ValueError("the state belongs to another model or optimizer")
        optimizers.zero_grad()
        model.train()
        logits, _, _ = model(batch["image"].permute(0, 3, 1, 2), None, eval_mode=False)
        loss = cross_entropy(logits.permute(0, 2, 3, 1), batch["pix_label"])
        loss.backward()
        optimizers.step(state.step)
        state.step += 1
        loss = loss.detach()
        return state, {"loss/loss": loss, "loss/cross_entropy": loss}

    return train_step


# ---------------------------------------------------------------------------
# Eval (AVSS validation: MIoU + ForegroundDetect, ALL + MS subsets)
# ---------------------------------------------------------------------------


class EvalMetrics(NamedTuple):
    miou_all: MIoUState
    miou_ms: MIoUState
    fg_all: torch.Tensor
    fg_ms: torch.Tensor


def eval_metrics_init(num_classes: int, device=None) -> EvalMetrics:
    """Zeroed accumulators on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
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
    hist = counts(idx.reshape(-1), 256 * n).reshape(n, 256)
    return (hist > thresh).sum(1) > 2


def _decomposable(model) -> bool:
    """Whether ``model`` has the decomposed methods the kernels are wired
    between (``CAVP`` has, the baseline ``VisualModel`` has not)."""
    return all(hasattr(model, m) for m in
               ("forward_visual_feature", "forward_audio_feature", "forward_cls"))


def _make_visual_feature_fn(model, config) -> Callable:
    """fea_v(image [B,3,H,W]) -> [B,latent,h,w], with ``use_pallas_layer1``
    routing ResNet layer1 through the fused bottleneck kernels
    (:mod:`cavp_tpu_torch.ops.kernels.layer1`). Eval only; DeepLabV3Plus.
    The kernel takes maps of any size; nothing falls back."""
    use_l1 = (config.use_pallas_layer1
              and getattr(model, "seg_model", "") == "DeepLabV3Plus")
    if not use_l1:
        return model.forward_visual_feature

    def fea_v_fn(image):
        resnet = model.backbone.backbone
        stem = resnet.stem_forward(image.to(model.dtype))
        # [B,H,W,C]: a view of the channels_last stem output
        c1 = fused_layer1(resnet, stem.permute(0, 2, 3, 1).contiguous())
        feats = resnet.forward_from_c1(c1.permute(0, 3, 1, 2))
        return model.segment.forward_feature(feats)

    return fea_v_fn


def make_inference_forward(model, config) -> Callable:
    """Returns fwd(image [N,H,W,3], audio [N,T,64,C]) -> logits [N,H,W,classes]."""
    use_fused = config.use_pallas_fusion and _decomposable(model)
    use_l1 = config.use_pallas_layer1 and _decomposable(model)
    fea_v_fn = _make_visual_feature_fn(model, config) if (use_fused or use_l1) else None

    @torch.inference_mode()
    def fwd(image, audio):
        image = image.permute(0, 3, 1, 2)
        audio = audio.permute(0, 3, 1, 2)
        if not (use_fused or use_l1):
            logits, _, _ = model(image, audio)
            return logits.permute(0, 2, 3, 1)
        fea_v = fea_v_fn(image)
        fea_a = model.forward_audio_feature(audio)
        h, w = fea_v.shape[-2:]
        if use_fused:
            # CAVP pins its cross-attention at 4 heads
            tokens = fused_visual_fusion(model, map_to_tokens(fea_v), fea_a, num_heads=4)
            fused = tokens_to_map(tokens, h, w)
        else:
            fused, _ = model.forward_fusion(fea_v, fea_a)
        return model.forward_cls(fused, image.shape[-2:]).permute(0, 2, 3, 1)

    return fwd


def make_eval_pred_forward(model, config) -> Callable:
    """Returns pred_fn(image, audio) -> int32 argmax mask [N, H, W].

    The metrics read only the argmax of the upsampled logits. With
    ``use_pallas_fusion`` the classifier-resolution logits are resized by
    the separable bilinear arm (H pass, round, W pass, round), and with
    ``use_pallas_argmax`` that resize and the argmax are one kernel whose
    mask is bitwise the same, so the full-resolution logits never reach
    device memory. A model without the decomposed methods takes the plain
    forward and the library argmax whatever the flags."""
    if not (config.use_pallas_fusion and _decomposable(model)):
        fwd = make_inference_forward(model, config)

        def pred_fn(image, audio):
            return fwd(image, audio).argmax(-1).to(torch.int32)

        return pred_fn

    use_argmax = config.use_pallas_argmax
    fea_v_fn = _make_visual_feature_fn(model, config)

    @torch.inference_mode()
    def pred_fn(image, audio):
        image = image.permute(0, 3, 1, 2)
        fea_v = fea_v_fn(image)
        fea_a = model.forward_audio_feature(audio.permute(0, 3, 1, 2))
        h, w = fea_v.shape[-2:]
        tokens = fused_visual_fusion(model, map_to_tokens(fea_v), fea_a, num_heads=4)
        head = model.segment.upsample(tokens_to_map(tokens, h, w))
        head = head.permute(0, 2, 3, 1).contiguous()  # [N,h,w,classes]
        if use_argmax:
            return upsample_argmax(head, image.shape[-2:])
        logits = interpolate_bilinear_separable(head, image.shape[-2:],
                                                align_corners=False)
        return logits.argmax(-1).to(torch.int32)

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
                                 spec_min=config.spec_min, spec_max=config.spec_max,
                                 use_pallas=config.use_pallas_mel)
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


# ---------------------------------------------------------------------------
# AVS-Object J&F test (S4 / MS3)
# ---------------------------------------------------------------------------


def make_jf_test_step(model, config) -> Callable:
    """Returns jf_step(batch) -> (J [V], F [V]), one value per video.

    batch: tensors on the model's device: image [V,T,H,W,3] (or one video
    [T,H,W,3], which gives 0-dim results), waveform [V,T,Ca,L], pix_label
    [V,T,H,W] in {0, 1}, valid [V,T]. The reference's J&F test
    (trainer_cavp_avs_obj.test:292-353): J is the per-video ``mask_iou`` of
    the argmax masks, F the per-video ``eval_fmeasure`` of the float32
    softmax of class 1. All V x T frames go through one forward (the
    reference loops over videos at batch 1), the model's plain forward with
    the plain log-mel, in the module's mode."""
    n_frames = config.mel_frames

    @torch.inference_mode()
    def jf_step(batch):
        image = batch["image"]
        single = image.dim() == 4
        if single:
            image = image[None]
        V, T = image.shape[:2]
        wave = batch["waveform"].reshape((V * T,) + tuple(batch["waveform"].shape[-2:]))
        audio = _preprocess_nchw(wave, n_frames=n_frames, spec_min=config.spec_min,
                                 spec_max=config.spec_max)
        gt = batch["pix_label"].float().reshape((V, T) + tuple(batch["pix_label"].shape[-2:]))
        valid = batch["valid"].reshape(V, T)
        flat = image.reshape((V * T,) + tuple(image.shape[2:])).permute(0, 3, 1, 2)
        logits, _, _ = model(flat, audio)  # [V*T, classes, H, W]
        H, W = logits.shape[-2:]
        pred_mask = logits.argmax(1).float().reshape(V, T, H, W)
        probs = torch.softmax(logits.float(), dim=1)[:, 1].reshape(V, T, H, W)
        j = mask_iou(pred_mask, gt, weight=valid)
        f = eval_fmeasure(probs, gt, weight=valid)
        if single:
            return j[0], f[0]
        return j, f

    return jf_step
