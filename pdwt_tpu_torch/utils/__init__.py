from .checkpoint import load_coeffs, save_coeffs
from .convert import (coeffs1d_from_numpy, coeffs1d_to_numpy, coeffs2d_from_numpy,
                      coeffs2d_to_numpy, coeffs3d_from_numpy, coeffs3d_to_numpy, default_device,
                      tensor_from_numpy, tensor_to_numpy, wavelet_from_arrays)
from .io import read_dat, write_dat

__all__ = ["read_dat", "write_dat", "save_coeffs", "load_coeffs", "coeffs1d_from_numpy",
           "coeffs1d_to_numpy", "coeffs2d_from_numpy", "coeffs2d_to_numpy",
           "coeffs3d_from_numpy", "coeffs3d_to_numpy", "default_device", "tensor_from_numpy",
           "tensor_to_numpy", "wavelet_from_arrays"]
