"""Loading a model's weights from a reference checkpoint
(``cavp_tpu/engine/checkpoint.py`` ``load_model_variables``, the ``.pth``
branch).

The port's modules carry the reference's state-dict names, so a reference
``.pth`` needs no translation: ``module.`` prefixes (DDP) are stripped and
every tensor is copied into the parameter or buffer of its name. The full
train state (optimizers, sound bank, epoch) and the JAX package's orbax
directories come with ``run_training`` (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import torch

# BatchNorm's step counter: not a weight, not tracked by the JAX package,
# and absent from the state dicts its exporter writes
_NOT_WEIGHTS = ("num_batches_tracked",)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` file's state dict: ``{"model": state_dict, ...}``
    (the reference's save format, engine/engine.py:72-100) or a bare state
    dict. Read with ``weights_only=True``: tensors and plain containers."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(f"{path} holds objects other than tensors and plain "
                         f"containers; it is not read") from exc
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
    ``ValueError``. An orbax directory raises ``NotImplementedError``."""
    if os.path.isdir(path) or not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{path}: only .pth/.pt checkpoints are read; orbax checkpoints come "
            "with run_training (ROADMAP.md Queue 1 item 3)")
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
