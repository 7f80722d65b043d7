from .cache import enable_compile_cache
from .checkpoint import load_coeffs, save_coeffs
from .convert import (coeffs1d_from_numpy, coeffs1d_to_numpy, coeffs2d_from_numpy,
                      coeffs2d_to_numpy, coeffs3d_from_numpy, coeffs3d_to_numpy, default_device,
                      tensor_from_numpy, tensor_to_numpy, wavelet_from_arrays)
from .debug import assert_finite, checked, validate_coeffs
from .interop import (dwt, dwt2, dwt_max_level, from_pywt, idwt, idwt2, iswt, iswt2, swt, swt2,
                      to_pywt, wavedec, wavedec2, wavedecn, waverec, waverec2, waverecn)
from .io import read_dat, write_dat
from .profiling import (device_time, device_time_any, record_spans, reset_spans, span_table,
                        trace)

__all__ = ["read_dat", "write_dat", "save_coeffs", "load_coeffs", "coeffs1d_from_numpy",
           "coeffs1d_to_numpy", "coeffs2d_from_numpy", "coeffs2d_to_numpy",
           "coeffs3d_from_numpy", "coeffs3d_to_numpy", "default_device", "tensor_from_numpy",
           "tensor_to_numpy", "wavelet_from_arrays", "assert_finite", "checked",
           "validate_coeffs", "to_pywt", "from_pywt", "dwt_max_level", "dwt", "idwt", "dwt2",
           "idwt2", "wavedec", "wavedec2", "wavedecn", "swt", "iswt", "swt2", "iswt2",
           "waverec", "waverec2", "waverecn", "device_time", "device_time_any", "trace",
           "record_spans", "span_table", "reset_spans",
           "enable_compile_cache"]
