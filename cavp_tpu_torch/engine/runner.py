"""Model and train-state construction, the training loop, the validation
loop and the J&F test loop (``cavp_tpu/engine/runner.py``).

:func:`run_training` is the reference's shared ``main()`` skeleton as one
engine: the datasets, the model and its optimizers from the config, a
resume from ``--ckpt_path``, the epoch loop with validation every 5
epochs (and every epoch from 50 on), ``best_model`` checkpoints on a
better mIoU, and a resumable ``preempt`` checkpoint on SIGTERM or Ctrl-C
(:class:`PreemptionSignal`). One process trains the global batch on one
device; training across processes comes with DDP (ROADMAP.md Queue 1
item 8).
"""

from __future__ import annotations

import math
import os
import random
import signal
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cavp_tpu_torch.config.setups import Config
from cavp_tpu_torch.data.pipeline import (
    DataLoader,
    collate_eval_videos,
    flatten_video_batch,
    repack_valid_frames,
)
from cavp_tpu_torch.device import resolve_device
from cavp_tpu_torch.engine.checkpoint import (
    Engine,
    load_model_variables,
    restore_checkpoint,
    wait_for_saves,
)
from cavp_tpu_torch.engine.loops import (
    eval_metrics_init,
    eval_metrics_result,
    make_eval_step,
    make_jf_test_step,
    make_train_step,
)
from cavp_tpu_torch.engine.optim import current_lrs, make_optimizer
from cavp_tpu_torch.engine.state import TrainState, create_train_state
from cavp_tpu_torch.models.cavp import CAVP, VisualModel
from cavp_tpu_torch.models.layers import init_parameters
from cavp_tpu_torch.utils import Tensorboard, logger


def build_model(config: Config, device=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.nn.Module:
    """The ``CAVP`` for ``config`` (the baseline ``VisualModel`` under
    ``config.use_baseline``) on ``device`` (default: the CUDA card; raises
    when there is none), in eval mode unless ``train``, in
    ``channels_last`` memory format, with float32 parameters drawn from
    ``generator`` (default: seeded with ``config.seed``)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32
    # built without storage, so torch's default draws, which
    # init_parameters overwrites, are not made (about half of the build)
    with torch.device("meta"):
        if config.use_baseline:
            model = VisualModel(
                num_classes=config.num_classes, visual_backbone=config.visual_backbone,
                last_three_dilation_stride=tuple(config.last_three_dilation_stride),
                dtype=dtype)
        else:
            model = CAVP(num_classes=config.num_classes, seg_model=config.seg_model,
                         visual_backbone=config.visual_backbone,
                         last_three_dilation_stride=tuple(config.last_three_dilation_stride),
                         audio_backbone=config.audio_backbone, in_plane=config.in_plane,
                         dtype=dtype)
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


def seed_everything(seed: int) -> None:
    """The host draws: the items' and the collation's ``random``, and
    numpy's. The step draws from the state's generator."""
    random.seed(seed)
    np.random.seed(seed)


def count_params(model: torch.nn.Module) -> float:
    """Parameters, in millions."""
    return sum(p.numel() for p in model.parameters()) / 1e6


def _global_batch(config: Config) -> int:
    """batch_size x gpus x nodes: the reference's global batch, one
    per-worker batch a DDP process. One device trains all of it."""
    return config.batch_size * max(config.gpus, 1) * max(config.nodes, 1)


def steps_per_epoch(config: Config, n_train: int,
                    max_steps_per_epoch: Optional[int] = None) -> int:
    """Optimizer steps an epoch: whole global batches of the ``n_train``
    items (at least one), capped by ``max_steps_per_epoch``."""
    steps = max(n_train // _global_batch(config), 1)
    return min(steps, max_steps_per_epoch) if max_steps_per_epoch else steps


def _several_processes() -> bool:
    return (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


class PreemptionSignal:
    """SIGTERM / SIGINT as a request to stop at the next step: the loop
    writes a resumable ``preempt`` checkpoint and raises
    :class:`PreemptedError`. A second Ctrl-C raises ``KeyboardInterrupt``
    at once. Handlers are installed from the main thread only (elsewhere
    ``install`` leaves them as they are); ``uninstall`` restores the
    previous ones."""

    def __init__(self):
        self.triggered = False
        self._prev = {}

    def install(self) -> "PreemptionSignal":
        def _handler(signum, frame):
            if self.triggered and signum == signal.SIGINT:
                self.uninstall()
                raise KeyboardInterrupt
            self.triggered = True
            logger.warning("caught signal %d: will checkpoint and exit at the next step "
                           "(Ctrl-C again aborts now)" % signum)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, _handler)
            except ValueError:  # not the main thread
                pass
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev = {}


class PreemptedError(RuntimeError):
    """Raised after the preemption checkpoint is written."""


class MetricReader:
    """The one-step-lagged read of the loop's metrics (``runner.py:326-337``).

    ``float()`` of a tensor on the card waits for everything queued before
    it, the step just dispatched included, so reading a step's metrics when
    the next step is dispatched would still wait for that step. Instead
    :meth:`push` stacks a step's metrics, copies them into pinned host
    memory without waiting and records an event; :meth:`read`, at the next
    display point, waits on that event only (``waits`` counts those
    waits). On the CPU nothing is queued and :meth:`read` reads the stack."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.waits = 0

    def push(self, step: int, metrics: Dict[str, torch.Tensor]):
        keys = list(metrics)
        values = torch.stack([metrics[k].detach().double() for k in keys])
        event = None
        if self.cuda:
            host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            host.copy_(values, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            values = host
        return step, keys, values, event

    def read(self, pending) -> tuple:
        """(step, {key: float})."""
        step, keys, values, event = pending
        if event is not None:
            event.synchronize()
            self.waits += 1
        return step, dict(zip(keys, values.tolist()))


def run_training(config: Config, variant: str, make_datasets: Callable,
                 ckpt_dir: str = "./checkpoints",
                 max_steps_per_epoch: Optional[int] = None,
                 eval_collate: Callable = collate_eval_videos,
                 eval_batch_size: int = 1,
                 profile_dir: Optional[str] = None,
                 preempt: Optional[PreemptionSignal] = None,
                 device=None, stats: Optional[dict] = None):
    """Train ``config.epochs`` epochs on ``device`` (default: the CUDA card;
    raises when there is none). ``make_datasets(config) -> (train_ds,
    test_ds, train_collate)``. Returns (state, best_miou). Under
    ``config.use_baseline`` the step is ``variant="baseline"`` whatever
    ``variant`` says (main_avss_resize.py:92-104).

    ``config.ckpt_path`` resumes: a checkpoint of this package restores
    the whole state (step, both optimizers, the sound bank, the
    generator) and ``best_iou``, and the loop restarts at epoch ``step //
    steps_per_epoch`` (a run preempted mid-epoch replays that epoch, as the
    JAX package's does); a reference ``.pth`` restores the weights only.
    ``profile_dir`` takes a ``torch.profiler`` trace of steps 10-15 of the
    first epoch. ``config.debug`` raises at the first non-finite loss, read
    at the lagged metric read (the JAX package's ``jax_debug_nans``).
    ``stats``, when given, receives the training loop's ``steps``,
    ``frames``, ``wall_s``, ``loader_wait_s`` (time spent waiting for the
    next batch) and ``metric_waits`` (waits on the lagged read's events),
    and ``validation_s``, updated at the end of every epoch."""
    preempt = (preempt or PreemptionSignal()).install()
    try:
        return _run_training(config, variant, make_datasets, ckpt_dir, max_steps_per_epoch,
                             eval_collate, eval_batch_size, profile_dir, preempt, device,
                             stats)
    finally:
        preempt.uninstall()
        # join the write in flight also when the loop raised; its error is
        # raised only when nothing else is
        wait_for_saves(raise_error=sys.exc_info()[0] is None)


def _run_training(config, variant, make_datasets, ckpt_dir, max_steps_per_epoch,
                  eval_collate, eval_batch_size, profile_dir, preempt, device, stats):
    if _several_processes():
        raise NotImplementedError(
            "training across processes is not ported yet (ROADMAP.md Queue 1 item 8)")
    device = resolve_device(device)
    seed_everything(config.seed)
    global_batch = _global_batch(config)
    train_ds, test_ds, train_collate = make_datasets(config)
    spe = steps_per_epoch(config, len(train_ds), max_steps_per_epoch)

    state = init_state(config, device, spe)
    start_epoch, best_iou = 0, 0.0
    if config.ckpt_path:
        extra = _restore_into_state(state, config.ckpt_path)
        best_iou = float(extra.get("best_iou", 0.0))
        start_epoch = min(state.step // spe, config.epochs)
        logger.info("restored checkpoint %s (step %d, resuming at epoch %d)"
                    % (config.ckpt_path, state.step, start_epoch))
    logger.info("Number of trainable parameters: %.4fM" % count_params(state.model))

    wandb_ = Tensorboard(config)
    engine = Engine(config, ckpt_dir)
    train_loader = DataLoader(train_ds, global_batch, train_collate, shuffle=True,
                              drop_last=True, num_workers=config.num_workers, seed=config.seed)
    if eval_collate is collate_eval_videos and eval_batch_size == 1 and config.resize_flag:
        # a fixed eval size: several videos a step
        eval_batch_size = 8
    test_loader = (DataLoader(test_ds, eval_batch_size, eval_collate,
                              num_workers=config.num_workers)
                   if test_ds is not None else None)
    if config.use_baseline:
        variant = "baseline"  # the visual-only CE step
    train_step = make_train_step(state.model, state.optimizers, config, variant=variant)
    state, best_iou = _epoch_loop(config, state, engine, wandb_, train_loader, test_loader,
                                  train_step, start_epoch, spe, profile_dir,
                                  device, best_iou, preempt, stats)
    wandb_.finish()
    return state, best_iou


def _epoch_loop(config, state, engine, wandb_, train_loader, test_loader, train_step,
                start_epoch, steps_per_epoch, profile_dir, device, best_iou=0.0,
                preempt=None, stats=None):
    schedule = state.optimizers.schedule
    reader = MetricReader(device)
    # kept up to date epoch by epoch, so a preempted run reports too
    run = stats if stats is not None else {}
    run.update(steps=0, frames=0, wall_s=0.0, loader_wait_s=0.0, validation_s=0.0,
               metric_waits=0)
    prof = None
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)

    def _emit(pending):
        """Read a previous step's metrics and log them with its lrs."""
        step, values = reader.read(pending)
        if config.debug:
            bad = {k: v for k, v in values.items() if k.startswith("loss/")
                   and not math.isfinite(v)}
            if bad:
                raise FloatingPointError(f"non-finite loss at step {step}: {bad}")
        values.update(current_lrs(schedule, config, step))
        wandb_.upload_metrics(values, step=step)

    for epoch in range(start_epoch, config.epochs):
        train_loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = 0
        pending = None
        batches = iter(train_loader)
        try:
            for batch_idx in range(steps_per_epoch):
                t = time.perf_counter()
                batch = next(batches, None)
                run["loader_wait_s"] += time.perf_counter() - t
                if batch is None:
                    break
                if profile_dir and epoch == 0 and batch_idx == 10:
                    prof = torch.profiler.profile(activities=activities)
                    prof.start()
                if preempt is not None and preempt.triggered:
                    logger.warning("preemption signal: writing a resumable checkpoint before exit")
                    path = engine.save(state, "preempt", blocking=True,
                                       extra_metrics={"best_iou": best_iou})
                    raise PreemptedError(f"preempted at epoch {epoch} step {state.step}; resume "
                                         f"with --ckpt_path {path}")
                batch.pop("name", None)
                state, metrics = train_step(state, _to_device(batch, device), epoch)
                engine.update_iteration(epoch, epoch * steps_per_epoch + batch_idx)
                n += 1
                if batch_idx % config.display_iter == 0:
                    if pending is not None:
                        _emit(pending)
                    pending = reader.push(state.step, metrics)
                if prof is not None and batch_idx == 15:
                    _stop_profile(prof, profile_dir, device)
                    prof = None
        finally:
            batches.close()  # stops the loader's producer
        if prof is not None:  # the epoch ended before step 15
            _stop_profile(prof, profile_dir, device)
            prof = None
        if pending is not None:
            _emit(pending)  # the epoch's last window
        dt = time.perf_counter() - t0
        run["steps"] += n
        run["frames"] += n * train_loader.batch_size
        run["wall_s"] += dt
        run["metric_waits"] = reader.waits
        logger.info(f"epoch {epoch}: {n} steps in {dt:.1f}s "
                    f"({n * train_loader.batch_size / max(dt, 1e-9):.2f} img/s)")

        if test_loader is not None and (epoch % 5 == 0 or epoch >= 50):
            t = time.perf_counter()
            state.model.eval()  # the train step sets train mode again
            results = run_validation(config, state.model, test_loader, device, wandb_=wandb_)
            run["validation_s"] += time.perf_counter() - t
            logger.info("|ALL| mIoU: %.4f | acc: %.4f | fdr: %.4f | f_1: %.4f | f_0.3: %.4f"
                        % (results["miou"], results["acc"], results["fdr"], results["f_1"],
                           results["f_0.3"]))
            if results["miou"] > best_iou:
                best_iou = results["miou"]
                for k, v in results.items():
                    wandb_.set_summary(f"best_{k}", v)
                if not config.ignore_ckpt:
                    # the host copies are made now; the file is written
                    # while the next epoch trains
                    engine.save(state, "best_model", blocking=False,
                                extra_metrics={"best_iou": best_iou})
            wandb_.upload_metrics(results, step=state.step)
    return state, best_iou


def _stop_profile(prof, profile_dir: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "train_steps.json"))


def _restore_into_state(state: TrainState, ckpt_path: str) -> dict:
    """Resume from ``ckpt_path``: a checkpoint of this package restores the
    whole state; a reference ``.pth`` (no ``step``) restores the model's
    weights only (``runner.py:412-419``). Returns the run's counters saved
    with it (``epoch``, ``iteration``, ``best_iou``)."""
    payload = restore_checkpoint(ckpt_path)
    if not (isinstance(payload, dict) and "step" in payload and "generator" in payload):
        report = load_model_variables(ckpt_path, state.model)
        if report["unexpected"]:
            logger.warning("checkpoint tensors with no place in the model: %s"
                           % report["unexpected"][:10])
        return {}
    state.load_state_dict(payload)
    return {k: payload[k] for k in ("epoch", "iteration", "best_iou") if k in payload}


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


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
    item 8). ``wandb_`` is the run's logger; the per-video image uploads of
    its ``eval_list`` are not ported (ROADMAP.md Queue 1 item 3), so it must
    have an empty one."""
    if wandb_ is not None and getattr(wandb_, "eval_list", None) != []:
        raise NotImplementedError(
            "the wandb_ per-video image upload is not ported yet (ROADMAP.md Queue 1 item 3)")
    if _several_processes():
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


# ---------------------------------------------------------------------------
# J&F test (AVSBench-Object)
# ---------------------------------------------------------------------------


def run_jf_test(config: Config, model, test_loader, device=None,
                stats: Optional[dict] = None) -> Dict[str, float]:
    """The ``test_avss_resize.py`` J&F test (trainer_cavp_avs_obj.py:346-353):
    each batch of padded videos through ``make_jf_test_step`` with the model
    in eval mode on ``device`` (default: the CUDA card), J and F kept per
    video on the device and read once, at the end; returns their means over
    the videos (``miou``, ``F_score``) and ``J&F``, their mean. ``stats``,
    when given, receives ``steps``, ``videos``, ``wall_s`` and
    ``loader_wait_s``."""
    device = resolve_device(device)
    model.eval()
    jf_step = make_jf_test_step(model, config)
    js, fs = [], []
    steps = videos = 0
    waited = 0.0
    start = time.perf_counter()
    batches = iter(test_loader)
    while True:
        t = time.perf_counter()
        batch = next(batches, None)
        waited += time.perf_counter() - t
        if batch is None:
            break
        for k in ("name", "img_label", "frame_available"):
            batch.pop(k, None)
        j, f = jf_step(_to_device(batch, device))
        js.append(j.reshape(-1))
        fs.append(f.reshape(-1))
        steps += 1
        videos += js[-1].numel()
    # the run's one wait for the device
    j_mean, f_mean = torch.stack([torch.cat(js).double().mean(),
                                  torch.cat(fs).double().mean()]).tolist()
    if stats is not None:
        stats.update(steps=steps, videos=videos, wall_s=time.perf_counter() - start,
                     loader_wait_s=waited)
    return {"miou": j_mean, "F_score": f_mean, "J&F": (j_mean + f_mean) / 2}
