from . import modes
from .haar import haar_dwt1d, haar_dwt2d, haar_idwt1d, haar_idwt2d
from .modes import MODES, dec_len, extend, rec_len
from .nonseparable import dwt2d_ns, idwt2d_ns, iswt2d_ns, swt2d_ns
from .separable import (Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, iswt2d,
                        iswt2d_denoise, swt1d, swt2d)
from .separable3d import (DETAIL_KEYS_3D, Coeffs3D, dwt3d, idwt3d, iswt3d, iswt3d_denoise,
                          swt3d)

__all__ = ["Coeffs1D", "Coeffs2D", "dwt1d", "dwt2d", "idwt1d", "idwt2d", "iswt1d", "swt1d",
           "swt2d", "iswt2d", "iswt2d_denoise", "Coeffs3D", "DETAIL_KEYS_3D", "dwt3d", "idwt3d",
           "swt3d", "iswt3d", "iswt3d_denoise", "dwt2d_ns", "idwt2d_ns", "swt2d_ns",
           "iswt2d_ns", "haar_dwt2d", "haar_idwt2d", "haar_dwt1d", "haar_idwt1d", "MODES",
           "dec_len", "rec_len", "extend", "modes"]
