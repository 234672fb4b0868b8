"""Model and train-state construction and the validation loop
(``cavp_tpu/engine/runner.py`` ``build_model``, ``init_state`` and
``run_validation``)."""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from cavp_tpu_torch.config.setups import Config
from cavp_tpu_torch.data.pipeline import flatten_video_batch, repack_valid_frames
from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.loops import eval_metrics_init, eval_metrics_result, make_eval_step
from cavp_tpu_torch.engine.optim import make_optimizer
from cavp_tpu_torch.engine.state import TrainState, create_train_state
from cavp_tpu_torch.models.cavp import CAVP
from cavp_tpu_torch.models.layers import init_parameters


def build_model(config: Config, device=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> CAVP:
    """The ``CAVP`` for ``config`` on ``device`` (default: the CUDA card;
    raises when there is none), in eval mode unless ``train``, in
    ``channels_last`` memory format, with float32 parameters drawn from
    ``generator`` (default: seeded with ``config.seed``)."""
    device = resolve_device(device)
    # built without storage, so torch's default draws, which
    # init_parameters overwrites, are not made (about half of the build)
    with torch.device("meta"):
        model = CAVP(num_classes=config.num_classes, seg_model=config.seg_model,
                     visual_backbone=config.visual_backbone,
                     last_three_dilation_stride=tuple(config.last_three_dilation_stride),
                     audio_backbone=config.audio_backbone, in_plane=config.in_plane,
                     dtype=torch.bfloat16 if config.compute_dtype == "bfloat16"
                     else torch.float32)
    model.to_empty(device="cpu")
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    init_parameters(model, generator)
    return model.to(device=device, memory_format=torch.channels_last).train(train)


def init_state(config: Config, device=None,
               steps_per_epoch: Optional[int] = None) -> TrainState:
    """A train-mode model from ``config.seed``, its optimizers and the
    state at step 0, on ``device`` (default: the CUDA card)."""
    device = resolve_device(device)
    model = build_model(config, device, train=True)
    optimizers, _ = make_optimizer(model, config, steps_per_epoch)
    return create_train_state(model, optimizers, config, device)


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy -> ``device``; to the card through pinned memory, copies that
    do not wait for the device."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def run_validation(config: Config, model, test_loader, device=None, wandb_=None,
                   stats: Optional[dict] = None) -> Dict[str, float]:
    """The reference's trainer.validation, batched: padded videos are
    flattened to frames (and, with ``config.eval_dense_pack``, repacked
    without their padding frames), each batch goes through
    ``make_eval_step`` with the metric accumulators kept on ``device``
    (default: the CUDA card), and the ten metrics come to the host once,
    at the end. ``stats``, when given, receives ``steps``, ``frames`` (valid
    frames), ``wall_s`` (the loop and the final transfer) and
    ``loader_wait_s`` (time spent waiting for the loader's next batch).

    One process only: sharded validation comes with DDP (ROADMAP.md Queue 1
    item 8), and the ``wandb_`` per-video image upload with the wandb
    logger (ROADMAP.md Queue 1 item 3)."""
    if wandb_ is not None:
        raise NotImplementedError(
            "the wandb_ image upload is not ported yet (ROADMAP.md Queue 1 item 3)")
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "validation across processes is not ported yet (ROADMAP.md Queue 1 item 8)")
    device = resolve_device(device)
    eval_step = make_eval_step(model, config)
    metrics = eval_metrics_init(config.num_classes, device)

    def flat_batches():
        for batch in test_loader:
            for k in ("name", "img_label", "frame_available"):
                batch.pop(k, None)
            if batch["image"].ndim == 5:  # padded videos -> flat frames
                batch = flatten_video_batch(batch)
            yield batch

    stream = flat_batches()
    if config.eval_dense_pack:
        stream = repack_valid_frames(stream)
    steps = frames = 0
    waited = 0.0
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        batch = next(stream, None)
        waited += time.perf_counter() - t
        if batch is None:
            break
        frames += int(np.count_nonzero(batch["valid"]))
        metrics = eval_step(metrics, _to_device(batch, device))
        steps += 1
    result = eval_metrics_result(metrics)
    # the run's one wait for the device: the ten metrics in one transfer
    values = torch.stack([v.double() for v in result.values()]).tolist()
    if stats is not None:
        stats.update(steps=steps, frames=frames, wall_s=time.perf_counter() - start,
                     loader_wait_s=waited)
    return dict(zip(result, values))
