"""Norms over a whole coefficient tree (counterpart of
``pdwt_tpu/ops/norms.py``): one 0-dim tensor on the coefficients' device,
summed over the approximation and every detail band."""
from __future__ import annotations

import torch

from ..core.separable import Coeffs2D


def _leaves(coeffs: Coeffs2D):
    yield coeffs.approx
    for band in coeffs.details:
        yield from band


def norm1(coeffs: Coeffs2D) -> torch.Tensor:
    """Sum of |coeff| over all subbands, approximation included."""
    return sum(torch.sum(torch.abs(x)) for x in _leaves(coeffs))


def norm2sq(coeffs: Coeffs2D) -> torch.Tensor:
    """Squared L2 norm over all subbands, approximation included."""
    return sum(torch.sum(torch.square(x)) for x in _leaves(coeffs))
