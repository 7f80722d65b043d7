"""Carry filters and coefficients between the JAX package and the port
without importing JAX: both sides meet in numpy arrays."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.separable import Coeffs2D
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


def coeffs2d_from_numpy(approx, details: Sequence[Sequence], device="cpu") -> Coeffs2D:
    """A :class:`Coeffs2D` of tensors on ``device`` from numpy arrays
    (``details[i] = (H, V, D)`` of level i+1), copied, dtypes kept."""
    t = lambda arr: torch.tensor(np.asarray(arr), device=device)
    return Coeffs2D(t(approx), tuple(tuple(t(x) for x in band) for band in details))


def coeffs2d_to_numpy(coeffs) -> Tuple[np.ndarray, List[Tuple[np.ndarray, ...]]]:
    """(approx, [(H, V, D), ...]) as host numpy arrays, from a port
    :class:`Coeffs2D` or any pair of array-likes in the same layout."""
    n = lambda x: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x))
    return n(coeffs[0]), [tuple(n(x) for x in band) for band in coeffs[1]]
