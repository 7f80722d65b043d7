"""Haar butterflies: the decimated periodization Haar DWT without a
convolution (counterpart of ``pdwt_tpu/core/haar.py``).

The JAX facade runs them for a 2-tap decimated transform off the TPU.
The port's facade does not: Haar runs its separable transforms like any
other filter (their plain versions on the CPU, the level kernels on the
card), which agree with these to roundoff.  Scaling as the reference:
one 0.5 per 2D butterfly, 1/sqrt(2) per 1D pair.  H is the difference
along the rows (y), V along the columns (x).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .conv import odd_extend
from .separable import Coeffs1D, Coeffs2D
from .shapes import level_sizes

_INV_SQRT2 = 0.7071067811865476


def _scalar(v: float, x: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to ``x``'s dtype, as JAX's ``x.dtype.type(v)``."""
    return torch.tensor(v, dtype=x.dtype)


def _haar2d_level(x: torch.Tensor):
    x = odd_extend(odd_extend(x, -1), -2)
    x00, x01 = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    x10, x11 = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    s = _scalar(0.5, x)
    sum_y0, sum_y1 = x00 + x10, x01 + x11
    dif_y0, dif_y1 = x00 - x10, x01 - x11
    return (s * (sum_y0 + sum_y1), s * (dif_y0 + dif_y1),   # a, h
            s * (sum_y0 - sum_y1), s * (dif_y0 - dif_y1))   # v, d


def _interleave2(even: torch.Tensor, odd: torch.Tensor, axis: int) -> torch.Tensor:
    axis = axis % even.ndim
    y = torch.stack([even, odd], dim=axis + 1)
    return y.reshape(even.shape[:axis] + (2 * even.shape[axis],) + even.shape[axis + 1:])


def _haar2d_level_inv(a, h, v, d, out_shape):
    s = _scalar(0.5, a)
    sum_y0, sum_y1 = a + v, a - v
    dif_y0, dif_y1 = h + d, h - d
    top = _interleave2(s * (sum_y0 + dif_y0), s * (sum_y1 + dif_y1), -1)
    bot = _interleave2(s * (sum_y0 - dif_y0), s * (sum_y1 - dif_y1), -1)
    return _interleave2(top, bot, -2)[..., :out_shape[0], :out_shape[1]]


def haar_dwt2d(x: torch.Tensor, levels: int) -> Coeffs2D:
    """Multi-level 2D Haar DWT over the trailing two axes."""
    details: List[Tuple[torch.Tensor, ...]] = []
    a = x
    for _ in range(levels):
        a, h, v, d = _haar2d_level(a)
        details.append((h, v, d))
    return Coeffs2D(a, tuple(details))


def haar_idwt2d(coeffs: Coeffs2D, shape: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`haar_dwt2d`; ``shape`` = (Nr, Nc) of the image."""
    rows = level_sizes(shape[0], coeffs.levels)
    cols = level_sizes(shape[1], coeffs.levels)
    a = coeffs.approx
    for i in range(coeffs.levels - 1, -1, -1):
        a = _haar2d_level_inv(a, *coeffs.details[i], (rows[i], cols[i]))
    return a


def haar_dwt1d(x: torch.Tensor, levels: int) -> Coeffs1D:
    """Multi-level 1D Haar DWT along the last axis."""
    details: List[torch.Tensor] = []
    a = x
    for _ in range(levels):
        a = odd_extend(a, -1)
        e, o = a[..., 0::2], a[..., 1::2]
        s = _scalar(_INV_SQRT2, a)
        a = s * (e + o)
        details.append(s * (e - o))
    return Coeffs1D(a, tuple(details))


def haar_idwt1d(coeffs: Coeffs1D, length: int) -> torch.Tensor:
    """Inverse of :func:`haar_dwt1d`; ``length`` is the signal's."""
    sizes = level_sizes(length, coeffs.levels)
    a = coeffs.approx
    for i in range(coeffs.levels - 1, -1, -1):
        d = coeffs.details[i]
        s = _scalar(_INV_SQRT2, a)
        a = _interleave2(s * (a + d), s * (a - d), -1)[..., :sizes[i]]
    return a
