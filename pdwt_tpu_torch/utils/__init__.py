from .convert import coeffs2d_from_numpy, coeffs2d_to_numpy, wavelet_from_arrays

__all__ = ["coeffs2d_from_numpy", "coeffs2d_to_numpy", "wavelet_from_arrays"]
