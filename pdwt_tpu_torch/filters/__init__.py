from .bank import (
    Wavelet,
    get_wavelet,
    list_wavelets,
    make_custom_wavelet,
    modwt_wavelet,
)

__all__ = ["Wavelet", "get_wavelet", "list_wavelets", "make_custom_wavelet",
           "modwt_wavelet"]
