"""Soft, hard and garrote thresholds on coefficient trees, 2D or 1D
(counterpart of ``pdwt_tpu/ops/threshold.py``).

* ``normalize``: beta is divided by sqrt(2) per level from level 1, and
  the approximation threshold is beta / sqrt(2)^nlevels;
* ``beta`` may be a scalar or a per-level (or per-level, per-band)
  sequence, which is already level-scaled, so ``normalize`` ignores it;
* beta is rounded to each band's dtype first, as JAX does, so a tree that
  mixes a float32 approximation with bf16 details (the bf16 tiers) takes
  a bf16 beta on its details.

``THR_ELEM`` holds the elementwise forms, which the fused
threshold-in-inverse kernel (``kernels/swt.py``) also applies.  The other
thresholds of the JAX package (group, firm, linf, shrink) come with
ROADMAP queue 1, item 4.
"""
from __future__ import annotations

import math
from typing import Union

import torch

from ..core.separable import Coeffs1D, Coeffs2D

Coeffs = Union[Coeffs1D, Coeffs2D]

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


def as_dtype_of(b, x: torch.Tensor):
    """beta rounded to ``x``'s dtype: a tensor for a tensor, a number for a
    number."""
    if isinstance(b, torch.Tensor):
        return b.to(x.dtype)
    return float(torch.tensor(b, dtype=x.dtype))


def _soft(x: torch.Tensor, b) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(x.abs() - as_dtype_of(b, x), 0)


def _hard(x: torch.Tensor, b) -> torch.Tensor:
    return torch.where(x.abs() > as_dtype_of(b, x), x, 0.0)


def beta_squared(b, x: torch.Tensor):
    """b * b rounded in ``x``'s dtype, as the JAX package and the CUDA
    kernel square beta: a number for a number, a tensor for a tensor."""
    if isinstance(b, torch.Tensor):
        b = b.to(x.dtype)
        return b * b
    b = torch.tensor(b, dtype=x.dtype)
    return float(b * b)


def _garrote(x: torch.Tensor, b) -> torch.Tensor:
    """Non-negative garrote, x * max(1 - (b/x)^2, 0).  b^2 is a 0-dim
    tensor: a number divided by a tensor would be its reciprocal times the
    number, rounded twice."""
    b2 = torch.as_tensor(beta_squared(b, x), dtype=x.dtype)
    return torch.where(x * x > b2, x - b2 / torch.where(x == 0, 1.0, x), 0.0)


#: the elementwise thresholds the fused threshold-in-inverse kernel takes
THR_ELEM = {"soft": _soft, "hard": _hard, "garrote": _garrote}


def detail_bands(coeffs: Coeffs):
    """(level i, band j, tensor) of every detail band: (H, V, D) of each 2D
    level with j = 0, 1, 2; the one band of each 1D level with j = None,
    as JAX's ``_map_details`` numbers them."""
    for i, det in enumerate(coeffs.details):
        if isinstance(det, torch.Tensor):
            yield i, None, det
        else:
            for j, x in enumerate(det):
                yield i, j, x


def _apply(fn, coeffs: Coeffs, beta, do_thresh_appcoeffs, normalize):
    thr = lambda x, i, j: fn(x, _resolve_beta(beta, i, j, normalize))
    details = tuple(thr(det, i, None) if isinstance(det, torch.Tensor)
                    else tuple(thr(x, i, j) for j, x in enumerate(det))
                    for i, det in enumerate(coeffs.details))
    approx = coeffs.approx
    if do_thresh_appcoeffs:
        approx = fn(approx, _app_beta(beta, coeffs.levels, normalize))
    return type(coeffs)(approx, details)


def soft_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Elementwise soft threshold (the L1 proximal operator)."""
    return _apply(_soft, coeffs, beta, do_thresh_appcoeffs, normalize)


def hard_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Elementwise hard threshold."""
    return _apply(_hard, coeffs, beta, do_thresh_appcoeffs, normalize)


def garrote_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                      normalize: bool = False) -> Coeffs:
    """Elementwise non-negative garrote threshold (Gao 1998): continuous
    like soft, asymptotically unbiased like hard."""
    return _apply(_garrote, coeffs, beta, do_thresh_appcoeffs, normalize)


#: the threshold ops on a coefficient tree, by mode name
THRESHOLD_OPS = {"soft": soft_threshold, "hard": hard_threshold,
                 "garrote": garrote_threshold}
