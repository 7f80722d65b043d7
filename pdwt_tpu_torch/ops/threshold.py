"""Soft and hard thresholds on coefficient trees (counterpart of
``pdwt_tpu/ops/threshold.py``).

* ``normalize``: beta is divided by sqrt(2) per level from level 1, and
  the approximation threshold is beta / sqrt(2)^nlevels;
* ``beta`` may be a scalar or a per-level (or per-level, per-band)
  sequence, which is already level-scaled, so ``normalize`` ignores it.

The other thresholds of the JAX package (group, garrote, firm, linf,
shrink) come with ROADMAP queue 1, item 4.
"""
from __future__ import annotations

import math

import torch

from ..core.separable import Coeffs2D

_SQRT2 = math.sqrt(2.0)


def _app_beta(beta, nlevels: int, normalize: bool):
    """beta / sqrt(2)^nlevels; a sequence contributes its coarsest entry
    (its first band's, if per-band)."""
    if isinstance(beta, (list, tuple)):
        b = beta[-1]
        return b[0] if isinstance(b, (list, tuple)) else b
    if not normalize:
        return beta
    return beta / (2 ** (nlevels // 2)) / (_SQRT2 if nlevels % 2 else 1.0)


def _resolve_beta(beta, i: int, j, normalize: bool):
    """Threshold of level i (0-based), band j."""
    if isinstance(beta, (list, tuple)):
        b = beta[i]
        if isinstance(b, (list, tuple)):
            b = b[0 if j is None else j]
        return b
    return beta / (_SQRT2 ** (i + 1)) if normalize else beta


def _soft(x: torch.Tensor, b) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(x.abs() - b, 0)


def _hard(x: torch.Tensor, b) -> torch.Tensor:
    return torch.where(x.abs() > b, x, 0.0)


def _apply(fn, coeffs: Coeffs2D, beta, do_thresh_appcoeffs, normalize):
    details = tuple(
        tuple(fn(x, _resolve_beta(beta, i, j, normalize)) for j, x in enumerate(band))
        for i, band in enumerate(coeffs.details))
    approx = coeffs.approx
    if do_thresh_appcoeffs:
        approx = fn(approx, _app_beta(beta, coeffs.levels, normalize))
    return Coeffs2D(approx, details)


def soft_threshold(coeffs: Coeffs2D, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs2D:
    """Elementwise soft threshold (the L1 proximal operator)."""
    return _apply(_soft, coeffs, beta, do_thresh_appcoeffs, normalize)


def hard_threshold(coeffs: Coeffs2D, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs2D:
    """Elementwise hard threshold."""
    return _apply(_hard, coeffs, beta, do_thresh_appcoeffs, normalize)
