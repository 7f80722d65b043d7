"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Importing this package builds nothing; the CUDA library is compiled at
the first kernel launch (see ``_build.py``).  ``LAUNCHES`` counts the
launches of every kernel of the package."""
from ._launch import LAUNCHES, reset_launch_counts
from .batched1d import (
    fwd_level_1d,
    fwd_level_1d_ad,
    fwd_level_1d_ref,
    inv_level_1d,
    inv_level_1d_ad,
    inv_level_1d_ref,
    swt_fwd_level_1d,
    swt_fwd_level_1d_ad,
    swt_fwd_level_1d_ref,
    swt_inv_level_1d,
    swt_inv_level_1d_ad,
    swt_inv_level_1d_ref,
)
from .matmul import (
    PAIR_SCHEMES,
    SCHEMES,
    bf16_l1_schemes,
    fwd_level_2d_mxu,
    fwd_level_2d_mxu_ad,
    fwd_level_2d_mxu_ref,
    inv_level_2d_mxu,
    inv_level_2d_mxu_ad,
    inv_level_2d_mxu_ref,
    mode_scheme,
    mxu_route_2d,
    swt_bf16_scheme,
    swt_scheme,
)
from .mxu1d import (
    fwd_level_1d_mxu,
    fwd_level_1d_mxu_ad,
    fwd_level_1d_mxu_ref,
    inv_level_1d_mxu,
    inv_level_1d_mxu_ad,
    inv_level_1d_mxu_ref,
    mxu_route_1d,
    swt_fwd_level_1d_mxu,
    swt_fwd_level_1d_mxu_ad,
    swt_fwd_level_1d_mxu_ref,
    swt_inv_level_1d_mxu,
    swt_inv_level_1d_mxu_ad,
    swt_inv_level_1d_mxu_ref,
)
from .separable import (
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
    tail_supported,
)
from .swt import (
    swt_fwd_level_2d,
    swt_fwd_level_2d_ad,
    swt_fwd_level_2d_ref,
    swt_inv_level_2d,
    swt_inv_level_2d_ad,
    swt_inv_level_2d_denoise_ad,
    swt_inv_level_2d_ref,
)

__all__ = [
    "LAUNCHES", "reset_launch_counts", "tail_supported",
    "fwd_level_2d", "inv_level_2d", "fwd_tail_2d", "inv_tail_2d",
    "fwd_level_2d_ref", "inv_level_2d_ref", "fwd_tail_2d_ref", "inv_tail_2d_ref",
    "fwd_level_2d_ad", "inv_level_2d_ad", "fwd_tail_2d_ad", "inv_tail_2d_ad",
    "swt_fwd_level_2d", "swt_inv_level_2d", "swt_fwd_level_2d_ref", "swt_inv_level_2d_ref",
    "swt_fwd_level_2d_ad", "swt_inv_level_2d_ad", "swt_inv_level_2d_denoise_ad",
    "fwd_level_1d", "inv_level_1d", "swt_fwd_level_1d", "swt_inv_level_1d",
    "fwd_level_1d_ref", "inv_level_1d_ref", "swt_fwd_level_1d_ref", "swt_inv_level_1d_ref",
    "fwd_level_1d_ad", "inv_level_1d_ad", "swt_fwd_level_1d_ad", "swt_inv_level_1d_ad",
    "SCHEMES", "PAIR_SCHEMES", "bf16_l1_schemes", "mode_scheme", "swt_scheme",
    "swt_bf16_scheme", "mxu_route_2d", "mxu_route_1d",
    "fwd_level_2d_mxu", "inv_level_2d_mxu", "fwd_level_2d_mxu_ref", "inv_level_2d_mxu_ref",
    "fwd_level_2d_mxu_ad", "inv_level_2d_mxu_ad",
    "fwd_level_1d_mxu", "inv_level_1d_mxu", "swt_fwd_level_1d_mxu", "swt_inv_level_1d_mxu",
    "fwd_level_1d_mxu_ref", "inv_level_1d_mxu_ref", "swt_fwd_level_1d_mxu_ref",
    "swt_inv_level_1d_mxu_ref", "fwd_level_1d_mxu_ad", "inv_level_1d_mxu_ad",
    "swt_fwd_level_1d_mxu_ad", "swt_inv_level_1d_mxu_ad",
]
