"""pdwt_tpu_torch: the PyTorch and CUDA port of pdwt-tpu.

A second package beside ``pdwt_tpu`` (the JAX reference, which stays as
it is), with the same module names:

* ``filters``  — the 72-wavelet bank and custom filters (numpy)
* ``core``     — ``dwt2d``/``idwt2d``, ``swt2d``/``iswt2d``/``iswt2d_denoise``,
  the batched 1D ``dwt1d``/``idwt1d``/``swt1d``/``iswt1d`` and the plain
  reference path (``conv``)
* ``kernels``  — hand-written CUDA kernels for Hopper (sm_90a), their
  plain PyTorch versions, launch counters and autograd Functions
* ``ops``      — soft/hard/garrote thresholds, norms (``thresholded_norm1``),
  circular shift
* ``models``   — the denoising step, DWT and TI (SWT)
* ``api``      — the stateful ``Wavelets`` facade
* ``utils``    — numpy conversions to and from the JAX package

The port so far covers the 2D separable periodization DWT, the 2D
stationary transform with its TI-denoise step (the threshold fused into
the inverse), and the batched 1D DWT and SWT (``Wavelets(ndim=1)``), each
in the exact tier, and the precision tiers (``mixed``, ``bf16-fast``,
``bf16-balanced``, ``bf16-accurate``; ``precision=`` on every entry point,
or ``precision_scope``) on the 2D DWT and the batched 1D transforms, on
fourteen CUDA kernels.  Importing the package needs no GPU and builds nothing;
the CUDA kernels are compiled at their first launch.
"""
from .api import Wavelets
from .core.precision import TIERS, precision_scope
from .core.separable import (Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d, iswt1d,
                             iswt2d, iswt2d_denoise, swt1d, swt2d)
from .filters import get_wavelet

__all__ = ["Wavelets", "get_wavelet", "dwt2d", "idwt2d", "swt2d", "iswt2d",
           "iswt2d_denoise", "Coeffs2D", "dwt1d", "idwt1d", "swt1d", "iswt1d", "Coeffs1D",
           "TIERS", "precision_scope"]
