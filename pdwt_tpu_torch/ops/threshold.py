"""Soft, hard and garrote thresholds on coefficient trees, 3D, 2D or 1D
(counterpart of ``pdwt_tpu/ops/threshold.py``).

* ``normalize``: beta is divided by sqrt(2) per level from level 1, and
  the approximation threshold is beta / sqrt(2)^nlevels;
* ``beta`` may be a scalar or a per-level (or per-level, per-band)
  sequence, which is already level-scaled, so ``normalize`` ignores it;
* beta is rounded to each band's dtype first, as JAX does, so a tree that
  mixes a float32 approximation with bf16 details (the bf16 tiers) takes
  a bf16 beta on its details.

``THR_ELEM`` holds the elementwise forms, which the fused
threshold-in-inverse kernel (``kernels/swt.py``) also applies.  Beside
them: the group (joint L2 over a level's bands) soft threshold, the firm
threshold, the L-infinity projection and the L2 shrink, in JAX's dtypes
(the group threshold squares and sums in the band's own dtype).  Every
division is tensor by tensor (``_const``).
"""
from __future__ import annotations

import math
from typing import Union

import torch

from ..core.separable import Coeffs1D, Coeffs2D
from ..core.separable3d import Coeffs3D
from ..utils.profiling import spanned

Coeffs = Union[Coeffs1D, Coeffs2D, Coeffs3D]

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


def _const(b, x: torch.Tensor) -> torch.Tensor:
    """beta as a 0-dim tensor of ``x``'s dtype on its device (a fill, no
    copy from the host).  A divisor must be one: PyTorch divides by a
    number, or on the card by a CPU scalar, as a product with its
    reciprocal, which rounds twice, and JAX divides."""
    if isinstance(b, torch.Tensor):
        return b.to(device=x.device, dtype=x.dtype)
    return torch.full((), b, dtype=x.dtype, device=x.device)


def _clip_linf(x: torch.Tensor, b) -> torch.Tensor:
    return torch.sign(x) * torch.minimum(x.abs(), _const(b, x))


def _firm(x: torch.Tensor, b1, b2) -> torch.Tensor:
    """0 below b1, x above b2, a linear ramp between."""
    b1, b2 = _const(b1, x), _const(b2, x)
    ax = x.abs()
    ramp = torch.sign(x) * b2 * (ax - b1) / (b2 - b1)
    return torch.where(ax <= b1, 0.0, torch.where(ax >= b2, x, ramp))


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
    level with j = 0, 1, 2 (the 7 bands of a 3D level, daa..ddd, with j =
    0..6); the one band of each 1D level with j = None,
    as JAX's ``_map_details`` numbers them."""
    for i, det in enumerate(coeffs.details):
        if isinstance(det, torch.Tensor):
            yield i, None, det
        else:
            for j, x in enumerate(det):
                yield i, j, x


def _map_details(coeffs: Coeffs, fn) -> tuple:
    """``fn(x, i, j)`` of every detail band, nested as the details are."""
    return tuple(fn(det, i, None) if isinstance(det, torch.Tensor)
                 else tuple(fn(x, i, j) for j, x in enumerate(det))
                 for i, det in enumerate(coeffs.details))


def _apply(fn, coeffs: Coeffs, beta, do_thresh_appcoeffs, normalize):
    details = _map_details(coeffs, lambda x, i, j: fn(x, _resolve_beta(beta, i, j, normalize)))
    approx = coeffs.approx
    if do_thresh_appcoeffs:
        approx = fn(approx, _app_beta(beta, coeffs.levels, normalize))
    return type(coeffs)(approx, details)


@spanned("ops")
def soft_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Elementwise soft threshold (the L1 proximal operator)."""
    return _apply(_soft, coeffs, beta, do_thresh_appcoeffs, normalize)


@spanned("ops")
def hard_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Elementwise hard threshold."""
    return _apply(_hard, coeffs, beta, do_thresh_appcoeffs, normalize)


@spanned("ops")
def garrote_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                      normalize: bool = False) -> Coeffs:
    """Elementwise non-negative garrote threshold (Gao 1998): continuous
    like soft, asymptotically unbiased like hard."""
    return _apply(_garrote, coeffs, beta, do_thresh_appcoeffs, normalize)


@spanned("ops")
def firm_threshold(coeffs: Coeffs, beta, beta2, *, do_thresh_appcoeffs: bool = False,
                   normalize: bool = False) -> Coeffs:
    """Firm (semisoft) threshold (Gao & Bruce 1997): zero below ``beta``,
    identity above ``beta2`` (> ``beta``), a linear ramp between; both
    scalars or per-level (per-band) sequences of one structure."""
    details = _map_details(coeffs, lambda x, i, j: _firm(
        x, _resolve_beta(beta, i, j, normalize), _resolve_beta(beta2, i, j, normalize)))
    approx = coeffs.approx
    if do_thresh_appcoeffs:
        n = coeffs.levels
        approx = _firm(approx, _app_beta(beta, n, normalize), _app_beta(beta2, n, normalize))
    return type(coeffs)(approx, details)


@spanned("ops")
def proj_linf(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = True) -> Coeffs:
    """Projection onto the L-infinity ball of radius ``beta`` (a scalar),
    the approximation included by default."""
    details = _map_details(coeffs, lambda x, i, j: _clip_linf(x, beta))
    approx = _clip_linf(coeffs.approx, beta) if do_thresh_appcoeffs else coeffs.approx
    return type(coeffs)(approx, details)


@spanned("ops")
def shrink(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = True) -> Coeffs:
    """L2 proximal operator: every band scaled by 1 / (1 + beta), formed
    before it is cast to the band's dtype."""
    f = 1.0 / (1.0 + beta)
    scale = lambda x: x * _const(f, x)
    details = _map_details(coeffs, lambda x, i, j: scale(x))
    approx = scale(coeffs.approx) if do_thresh_appcoeffs else coeffs.approx
    return type(coeffs)(approx, details)


@spanned("ops")
def group_soft_threshold(coeffs: Coeffs, beta, *, do_thresh_appcoeffs: bool = False,
                         normalize: bool = False) -> Coeffs:
    """Group-lasso soft threshold: each position of a level shrinks its
    bands by the joint L2 norm over them, the approximation joining the
    coarsest level's group under ``do_thresh_appcoeffs`` (a 3D level's group
    is its 7 bands).  ``beta`` is a scalar (a number or a 0-dim tensor); a
    sequence raises ``ValueError``.  The squares are summed in the
    bands' own dtype; where a float32 approximation joins bf16 details,
    the factor and the details come out float32."""
    if isinstance(beta, (list, tuple)):
        raise ValueError("group_soft_threshold takes a scalar beta (a number or a 0-dim "
                         "tensor), not a per-level or per-band sequence")
    n = coeffs.levels
    details, approx = [], coeffs.approx
    for i, det in enumerate(coeffs.details):
        b = beta / (_SQRT2 ** (i + 1)) if normalize else beta
        include_a = do_thresh_appcoeffs and i == n - 1
        bands = (det,) if isinstance(det, torch.Tensor) else det
        norm2 = sum(x * x for x in bands)
        if include_a:
            norm2 = norm2 + approx * approx
        norm = torch.sqrt(norm2)
        fac = torch.where(norm > 0, torch.clamp_min(1 - _const(b, norm) / norm, 0), 0.0)
        details.append(det * fac if isinstance(det, torch.Tensor)
                       else tuple(x * fac for x in bands))
        if include_a:
            approx = approx * fac
    return type(coeffs)(approx, tuple(details))


#: the threshold ops on a coefficient tree, by mode name
THRESHOLD_OPS = {"soft": soft_threshold, "hard": hard_threshold,
                 "group": group_soft_threshold, "garrote": garrote_threshold}
