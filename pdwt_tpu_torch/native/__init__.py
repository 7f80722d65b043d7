"""ctypes binding of the C++ CPU engine (``cpp/pdwt_cpu.cpp``): the port's
counterpart of ``pdwt_tpu/native``.

The engine is the reference's float64-accumulating CPU oracle.  The port
compiles it itself with ``g++`` and the flags of ``cpp/Makefile`` (the
float32 library, and the float64 one with ``-DPDWT_DOUBLEPRECISION``) into
the build directory of ``utils/cache.py``, each file named by a hash of the
source, the header and the flags and moved into place with an atomic
rename, so parallel processes never race on one file.  It takes CPU
tensors or numpy arrays and returns the port's ``Coeffs1D``/``Coeffs2D``/
``Coeffs3D`` of CPU tensors; a CUDA tensor raises.
"""
from .lib import (axpy, build, dwt1d, dwt2d, dwt2d_ns, dwt3d, firm_threshold, garrote_threshold,
                  get_dtype, group_soft_threshold, idwt1d, idwt2d, idwt2d_ns, idwt3d,
                  is_available, norm1, norm2sq, norm_l21, set_dtype, shrink, soft_threshold)

__all__ = [
    "build", "is_available",
    "dwt2d", "idwt2d", "dwt1d", "idwt1d", "dwt3d", "idwt3d",
    "dwt2d_ns", "idwt2d_ns",
    "soft_threshold", "group_soft_threshold", "shrink", "axpy",
    "garrote_threshold", "firm_threshold",
    "norm1", "norm2sq", "norm_l21",
]
