from .convert import (coeffs1d_from_numpy, coeffs1d_to_numpy, coeffs2d_from_numpy,
                      coeffs2d_to_numpy, tensor_from_numpy, tensor_to_numpy,
                      wavelet_from_arrays)

__all__ = ["coeffs1d_from_numpy", "coeffs1d_to_numpy", "coeffs2d_from_numpy",
           "coeffs2d_to_numpy", "tensor_from_numpy", "tensor_to_numpy",
           "wavelet_from_arrays"]
