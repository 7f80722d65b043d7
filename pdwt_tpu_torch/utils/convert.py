"""Carry filters and coefficients between the JAX package and the port
without importing JAX: both sides meet in numpy arrays.

bfloat16 crosses without ``ml_dtypes``: a numpy array whose dtype is named
``bfloat16`` (as JAX hands one out) comes in through its 16-bit view, bit
for bit; a bf16 tensor goes out as a float32 array, which holds every bf16
value exactly."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.separable import Coeffs1D, Coeffs2D
from ..core.separable3d import Coeffs3D
from ..filters import Wavelet


def wavelet_from_arrays(obj_or_name, dec_lo=None, dec_hi=None, rec_lo=None,
                        rec_hi=None) -> Wavelet:
    """A port :class:`Wavelet` from any object with ``name``, ``dec_lo``,
    ``dec_hi``, ``rec_lo`` and ``rec_hi`` attributes (such as a JAX
    ``Wavelet``), or from a name and the four filters."""
    if isinstance(obj_or_name, str):
        filters = (dec_lo, dec_hi, rec_lo, rec_hi)
        if any(f is None for f in filters):
            raise ValueError("give all four filters with a name")
        return Wavelet(obj_or_name.lower(), *filters)
    return Wavelet(str(obj_or_name.name),
                   *(np.asarray(getattr(obj_or_name, f), dtype=np.float64)
                     for f in ("dec_lo", "dec_hi", "rec_lo", "rec_hi")))


def default_device(device) -> torch.device:
    """``device``, or the CUDA card; never the CPU unless asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the port runs on the CUDA card unless device= names another "
                           "device, and torch finds no CUDA card here; pass device=\"cpu\" "
                           "to run on the CPU")
    return torch.device("cuda")


def same_device(t: torch.Tensor, device: torch.device) -> bool:
    """Does ``t`` lie on ``device`` (any index if ``device`` names none)?"""
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def image_tensor(img, device=None, dtype=None) -> torch.Tensor:
    """A facade's input as a tensor in ``dtype`` (None keeps its dtype): a
    tensor stays on its device (``ValueError`` if ``device`` names another),
    host data goes to ``default_device(device)``."""
    if isinstance(img, torch.Tensor):
        if device is not None and not same_device(img, torch.device(device)):
            raise ValueError(f"img lies on {img.device}, not on device={device}; "
                             "move it first")
        return img.to(dtype=dtype)
    return tensor_from_numpy(img, default_device(device), dtype)


def tensor_from_numpy(arr, device="cpu", dtype=None) -> torch.Tensor:
    """A tensor on ``device`` copied from an array-like, in ``dtype`` (None
    keeps the array's); a bfloat16 numpy array comes in bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a tensor; bf16 comes out as float32 (exact)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _host(x) -> np.ndarray:
    return tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def coeffs2d_from_numpy(approx, details: Sequence[Sequence], device="cpu") -> Coeffs2D:
    """A :class:`Coeffs2D` of tensors on ``device`` from numpy arrays
    (``details[i] = (H, V, D)`` of level i+1), copied, dtypes kept (a
    bfloat16 array becomes a bf16 tensor)."""
    t = lambda arr: tensor_from_numpy(arr, device)
    return Coeffs2D(t(approx), tuple(tuple(t(x) for x in band) for band in details))


def coeffs2d_to_numpy(coeffs) -> Tuple[np.ndarray, List[Tuple[np.ndarray, ...]]]:
    """(approx, [(H, V, D), ...]) as host numpy arrays, from a port
    :class:`Coeffs2D` or any pair of array-likes in the same layout."""
    return _host(coeffs[0]), [tuple(_host(x) for x in band) for band in coeffs[1]]


def coeffs1d_from_numpy(approx, details: Sequence, device="cpu") -> Coeffs1D:
    """A :class:`Coeffs1D` of tensors on ``device`` from numpy arrays
    (``details[i]`` the detail band of level i+1), copied, dtypes kept."""
    t = lambda arr: tensor_from_numpy(arr, device)
    return Coeffs1D(t(approx), tuple(t(x) for x in details))


def coeffs1d_to_numpy(coeffs) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(approx, [detail of level 1, 2, ...]) as host numpy arrays, from a
    port :class:`Coeffs1D` or any pair of array-likes in the same layout
    (such as a JAX ``Coeffs1D``)."""
    return _host(coeffs[0]), [_host(x) for x in coeffs[1]]


def coeffs3d_from_numpy(approx, details: Sequence[Sequence], device="cpu") -> Coeffs3D:
    """A :class:`Coeffs3D` of tensors on ``device`` from numpy arrays
    (``details[i]`` the 7 bands daa..ddd of level i+1), copied, dtypes
    kept."""
    t = lambda arr: tensor_from_numpy(arr, device)
    return Coeffs3D(t(approx), tuple(tuple(t(x) for x in band) for band in details))


def coeffs3d_to_numpy(coeffs) -> Tuple[np.ndarray, List[Tuple[np.ndarray, ...]]]:
    """(approx, [(daa, ..., ddd), ...]) as host numpy arrays, from a port
    :class:`Coeffs3D` or any pair of array-likes in the same layout (such as
    a JAX ``Coeffs3D``)."""
    return _host(coeffs[0]), [tuple(_host(x) for x in band) for band in coeffs[1]]
