from .separable import Coeffs2D, dwt2d, idwt2d

__all__ = ["Coeffs2D", "dwt2d", "idwt2d"]
