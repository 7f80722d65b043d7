from .bank import (
    Wavelet,
    factor_quads,
    get_wavelet,
    list_wavelets,
    make_custom_wavelet,
    modwt_wavelet,
    quad_filters,
)

__all__ = ["Wavelet", "get_wavelet", "list_wavelets", "make_custom_wavelet",
           "modwt_wavelet", "quad_filters", "factor_quads"]
