"""Train CAVP on VPO with stereo audio on the CUDA card.

    python -m cavp_tpu_torch.main_vpo_stereo --setup vpo_ss|vpo_ms|vpo_msmi \\
        --root_dataset_dir <dir holding VPO/ and vggsound_bench/> [flags]

The port of the root ``main_vpo_stereo.py``: ``main_vpo_mono``'s run with
``in_plane=2``, the ``vpo_*_data_stereo.csv`` rows panned to two channels
(mixed, and mirrored with the train flip, for the multi-source setups),
and the ``vpo_stereo`` train step (the overwrite of the labels only,
without the background-only samples, no bank, the audio tower on the B
unshuffled clips and the shuffled half a feature gather).
"""

from __future__ import annotations

from typing import Optional, Sequence

from cavp_tpu_torch.main_vpo_mono import main as _main


def main(argv: Optional[Sequence[str]] = None, device=None, stats: Optional[dict] = None):
    """``main_vpo_mono.main`` for stereo audio."""
    return _main(argv, device=device, stats=stats, stereo=True)


if __name__ == "__main__":
    main()
