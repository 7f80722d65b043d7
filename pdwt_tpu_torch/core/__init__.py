from .separable import Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, swt1d

__all__ = ["Coeffs1D", "Coeffs2D", "dwt1d", "dwt2d", "idwt1d", "idwt2d", "iswt1d", "swt1d"]
