"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Importing this package builds nothing; the CUDA library is compiled at
the first kernel launch (see ``_build.py``)."""
from .separable import (
    LAUNCHES,
    fwd_level_2d,
    fwd_level_2d_ad,
    fwd_level_2d_ref,
    fwd_tail_2d,
    fwd_tail_2d_ad,
    fwd_tail_2d_ref,
    inv_level_2d,
    inv_level_2d_ad,
    inv_level_2d_ref,
    inv_tail_2d,
    inv_tail_2d_ad,
    inv_tail_2d_ref,
    reset_launch_counts,
    tail_supported,
)

__all__ = [
    "LAUNCHES", "reset_launch_counts", "tail_supported",
    "fwd_level_2d", "inv_level_2d", "fwd_tail_2d", "inv_tail_2d",
    "fwd_level_2d_ref", "inv_level_2d_ref", "fwd_tail_2d_ref", "inv_tail_2d_ref",
    "fwd_level_2d_ad", "inv_level_2d_ad", "fwd_tail_2d_ad", "inv_tail_2d_ad",
]
