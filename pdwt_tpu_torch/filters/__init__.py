from .bank import (
    MAX_FILTER_WIDTH,
    Wavelet,
    factor_quads,
    get_wavelet,
    list_wavelets,
    make_custom_wavelet,
    modwt_wavelet,
    quad_filters,
    register_wavelet,
)

__all__ = ["Wavelet", "get_wavelet", "list_wavelets", "make_custom_wavelet",
           "register_wavelet", "modwt_wavelet", "quad_filters", "factor_quads",
           "MAX_FILTER_WIDTH"]
