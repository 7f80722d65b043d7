from .nonseparable import dwt2d_ns, idwt2d_ns, iswt2d_ns, swt2d_ns
from .separable import Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, swt1d

__all__ = ["Coeffs1D", "Coeffs2D", "dwt1d", "dwt2d", "idwt1d", "idwt2d", "iswt1d", "swt1d",
           "dwt2d_ns", "idwt2d_ns", "swt2d_ns", "iswt2d_ns"]
