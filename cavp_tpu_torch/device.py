"""Where the port's entry points put their tensors.

Every entry point that allocates (``build_model``, ``Predictor``,
``eval_metrics_init``, ``miou_init``, ``fg_init``, ``init_bank``,
``create_train_state``, ``init_state``) takes ``device=None``, which means
the CUDA card. The port never picks the CPU on its own: a caller that
wants it (the CPU tests do) passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given.
    Raises ``RuntimeError`` when the CUDA device is asked for (by
    default or by name) and this machine has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        how = "the default device" if device is None else f"device {device!r}"
        raise RuntimeError(
            f"{how} is CUDA, and no CUDA device is available on this machine; "
            "pass device=\"cpu\" to run on the CPU")
    return dev
