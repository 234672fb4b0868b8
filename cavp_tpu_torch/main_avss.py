"""Train CAVP on AVSBench-Semantics on the CUDA card.

    python -m cavp_tpu_torch.main_avss --setup avss \\
        --root_dataset_dir <dir holding avsbench_semantic/> [flags]

The port of the root ``main_avss.py``, whose reference file cannot run as
committed: it is :func:`cavp_tpu_torch.main_avss_resize.main`, the same
engine and command line.
"""

from cavp_tpu_torch.main_avss_resize import main

__all__ = ["main"]

if __name__ == "__main__":
    main()
