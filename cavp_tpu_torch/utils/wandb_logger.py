"""Console logging and the run's metric log (``cavp_tpu/utils/wandb_logger.py``).

The reference's ``utils/tensor_board.py`` ``Tensorboard`` in wandb's
disabled mode, the JAX package's default: metrics go to an in-memory
``history``, best values to ``summary``. Uploading to wandb
(``--wandb_mode`` online or offline) and the per-video image uploads
(and with them the display palette) are not ported (ROADMAP.md Queue 1
item 3): the card's machines have no network and no wandb.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("cavp_tpu_torch")


def log_to_console() -> None:
    """Give the package's logger one console handler at INFO (an entry
    point calls this; importing the package configures nothing)."""
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)


class Tensorboard:
    """The reference class's surface in disabled mode (``--wandb_mode``
    takes no other value here): ``upload_metrics`` keeps the scalars, with
    their step, in ``history``, ``set_summary`` in ``summary``. Its
    ``eval_list`` (the videos whose images validation uploads) is empty."""

    def __init__(self, config):
        self.config = config
        self.eval_list: List[str] = []
        self.history: List[Dict[str, float]] = []
        self.summary: Dict[str, float] = {}

    def upload_metrics(self, metrics: Dict, step: Optional[int] = None) -> None:
        scalar = {k: float(v) for k, v in metrics.items()
                  if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
        if step is not None:
            scalar["step"] = step
        self.history.append(scalar)

    def set_summary(self, key: str, value) -> None:
        self.summary[key] = float(value)

    def finish(self) -> None:
        pass
