"""pdwt_tpu_torch: the PyTorch and CUDA port of pdwt-tpu.

A second package beside ``pdwt_tpu`` (the JAX reference, which stays as
it is), with the same module names:

* ``filters``  — the 72-wavelet bank and custom filters (numpy)
* ``core``     — ``dwt2d``/``idwt2d`` and the plain reference path (``conv``)
* ``kernels``  — hand-written CUDA kernels for Hopper (sm_90a), their
  plain PyTorch versions, launch counters and autograd Functions
* ``ops``      — soft/hard thresholds, norms, circular shift
* ``models``   — the denoising step
* ``api``      — the stateful ``Wavelets`` facade
* ``utils``    — numpy conversions to and from the JAX package

This first slice is the 2D separable periodization DWT.  Importing the
package needs no GPU and builds nothing; the CUDA kernels are compiled
at their first launch.
"""
from .api import Wavelets
from .core.separable import Coeffs2D, dwt2d, idwt2d
from .filters import get_wavelet

__all__ = ["Wavelets", "get_wavelet", "dwt2d", "idwt2d", "Coeffs2D"]
