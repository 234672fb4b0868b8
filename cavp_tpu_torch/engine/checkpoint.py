"""Checkpoints: the full train state and a model's weights
(``cavp_tpu/engine/checkpoint.py``).

A checkpoint is one ``torch.save`` file holding the reference's payload
(``engine/engine.py:72-100``: ``model`` under the reference's state-dict
names, ``visual_optimizer``, ``audio_optimizer``, ``epoch``,
``iteration``) and the JAX package's extras (``step``, ``sound_bank``,
``best_iou``), with the step's ``generator`` state. It is read with
``weights_only=True``: tensors and plain containers only. Its ``model``
is a reference state dict, so the evaluation entry point, the JAX
package's ``.pth`` loader and the reference's tooling read it as they are.

- :func:`save_checkpoint` writes to ``<path>.pending`` and renames it
  into place, so a write that dies never costs the last good file; with
  ``blocking=False`` the file is written on a background thread from host
  copies made before the call returns (the step updates the model and the
  optimizers in place);
- :func:`wait_for_saves` joins that write and raises its error, if any,
  at the next wait or save;
- :func:`save_and_link_checkpoint` keeps an ``epoch-last.pth`` alias;
- :func:`restore_checkpoint` reads a file after joining a pending write
  without raising its error;
- :func:`load_model_variables` loads a ``.pth`` / ``.pt`` file's model
  weights into a model, with a report.

The JAX package's orbax directories are not read: orbax needs jax.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
from typing import Any, Dict, List, Optional

import torch

# BatchNorm's step counter: not a weight, not tracked by the JAX package,
# and absent from the state dicts its exporter writes
_NOT_WEIGHTS = ("num_batches_tracked",)
SUFFIX = ".pth"

_save_thread: Optional[threading.Thread] = None
_save_error: Optional[BaseException] = None


def _refuse_directory(path: str) -> None:
    if os.path.isdir(path) or not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{path}: only .pth/.pt checkpoint files are read; orbax checkpoint "
            "directories need jax, which this package does not use")


def _read(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(f"{path} holds objects other than tensors and plain "
                         f"containers; it is not read") from exc


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` file's model state dict: the file's ``model``
    (the reference's save format, engine/engine.py:72-100, and this
    package's) or the file itself when it is a bare state dict."""
    ckpt = _read(path)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
    return ckpt


def load_model_variables(path: str, model: torch.nn.Module) -> Dict[str, List[str]]:
    """Load ``path`` into ``model`` in place and report what did not match.

    Returns ``{"missing": [...], "unexpected": [...], "converted": [...]}``
    as the JAX package's loader does: the model's tensors the file did not
    fill (BatchNorm's ``num_batches_tracked`` is not a weight and is not
    listed), the file's tensors the model has no place for, and the names
    loaded. A tensor whose shape differs from its place raises
    ``ValueError``. An orbax directory raises ``NotImplementedError``.

    The port's names are the reference's for every ``seg_model`` (the JAX
    package's loader takes ``seg_model`` to pick its name translation,
    ``cavp_tpu/engine/checkpoint.py:161-176``): the model built for
    ``--seg_model`` decides what the file must hold."""
    _refuse_directory(path)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in load_torch_checkpoint(path).items()}
    own = model.state_dict()
    bad = [f"{k}: {tuple(v.shape)} into {tuple(own[k].shape)}"
           for k, v in sd.items() if k in own and tuple(v.shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"{path}: shapes differ from the model's: {bad[:10]}")
    report = {
        "missing": [k for k in own if k not in sd and not k.endswith(_NOT_WEIGHTS)],
        "unexpected": [k for k in sd if k not in own],
        "converted": [k for k in sd if k in own],
    }
    model.load_state_dict({k: sd[k] for k in report["converted"]}, strict=False)
    return report


def _atomic_save(path: str, payload) -> None:
    """Write ``<path>.pending``, then rename it over ``path``: the old file
    stays whole until the new one is."""
    pending = path + ".pending"
    torch.save(payload, pending)
    os.replace(pending, path)


def wait_for_saves(raise_error: bool = True) -> None:
    """Block until the write in flight, if any, has finished. Its error is
    raised (``raise_error=True``: the runner, and every save before it
    starts) or logged and kept for the next wait (``raise_error=False``:
    a restore, which must not take another path's failure for its own)."""
    global _save_thread, _save_error
    if _save_thread is not None:
        _save_thread.join()
        _save_thread = None
    if _save_error is not None:
        if raise_error:
            err, _save_error = _save_error, None
            raise err
        logging.getLogger("cavp_tpu_torch").warning(
            "pending async checkpoint write failed: %r", _save_error)


def save_checkpoint(path: str, state, extra: Optional[Dict[str, Any]] = None,
                    blocking: bool = True) -> str:
    """Write ``state``'s full payload (:meth:`TrainState.state_dict`) and
    ``extra`` (``epoch``, ``iteration``, ``best_iou``) to ``path``; returns
    the absolute path. The host copies are made before this returns; with
    ``blocking=False`` the file is written on a background thread. One
    write is in flight at a time: a save first joins the previous one and
    raises its error."""
    path = os.path.abspath(path)
    payload = state.state_dict()
    payload.update(extra or {})
    wait_for_saves()
    if blocking:
        _atomic_save(path, payload)
        return path

    global _save_thread

    def _write():
        global _save_error
        try:
            _atomic_save(path, payload)
        except BaseException as exc:  # raised by the next wait or save
            _save_error = exc

    _save_thread = threading.Thread(target=_write, daemon=True, name="ckpt-save")
    _save_thread.start()
    return path


def save_and_link_checkpoint(ckpt_dir: str, name: str, state,
                             extra: Optional[Dict[str, Any]] = None,
                             blocking: bool = True) -> str:
    """engine/engine.py:107-112: ``<ckpt_dir>/<name>.pth`` and an
    ``epoch-last.pth`` alias of it. With ``blocking=False`` the alias
    points at the write in flight: wait for it before reading."""
    path = save_checkpoint(os.path.join(ckpt_dir, name + SUFFIX), state, extra,
                           blocking=blocking)
    link = os.path.join(ckpt_dir, "epoch-last" + SUFFIX)
    if os.path.lexists(link):
        os.remove(link)
    os.symlink(path, link)
    return path


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint file, on the host. A write in flight is
    joined first; its error is not raised here (it is another path's)."""
    _refuse_directory(path)
    wait_for_saves(raise_error=False)
    return _read(path)


class Engine:
    """Run-state holder (engine/engine.py:17-121): the epoch and iteration
    counters and the checkpoint directory; the state lives in
    :class:`TrainState`."""

    def __init__(self, config, ckpt_dir: str = "./checkpoints"):
        self.config = config
        self.ckpt_dir = ckpt_dir
        self.epoch = 0
        self.iteration = 0
        os.makedirs(ckpt_dir, exist_ok=True)

    def update_iteration(self, epoch: int, iteration: int) -> None:
        self.epoch = epoch
        self.iteration = iteration

    def save(self, state, name: Optional[str] = None, blocking: bool = True,
             extra_metrics: Optional[Dict[str, Any]] = None) -> str:
        name = name or f"epoch-{self.epoch}"
        extra = {"epoch": self.epoch, "iteration": self.iteration}
        extra.update(extra_metrics or {})
        return save_and_link_checkpoint(self.ckpt_dir, name, state, extra=extra,
                                        blocking=blocking)
