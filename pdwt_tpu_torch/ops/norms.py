"""Norms over a whole coefficient tree, 2D or 1D (counterpart of
``pdwt_tpu/ops/norms.py``): one 0-dim tensor on the coefficients' device,
summed over the approximation and every detail band.  bf16 bands are
summed in float32, as JAX does (``pdwt_tpu/ops/norms.py:27-28``).  ``norm_l21`` and the
algebra ops come with ROADMAP queue 1, item 4."""
from __future__ import annotations

import torch

from .threshold import Coeffs, detail_bands


def _leaves(coeffs: Coeffs):
    yield coeffs.approx
    for _, _, x in detail_bands(coeffs):
        yield x


def _accum(x: torch.Tensor) -> torch.dtype:
    """The dtype a sum over ``x`` accumulates in: float32 for bf16."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def norm1(coeffs: Coeffs) -> torch.Tensor:
    """Sum of |coeff| over all subbands, approximation included."""
    return sum(torch.sum(torch.abs(x), dtype=_accum(x)) for x in _leaves(coeffs))


def norm2sq(coeffs: Coeffs) -> torch.Tensor:
    """Squared L2 norm over all subbands, approximation included."""
    return sum(torch.sum(torch.square(x.to(_accum(x)))) for x in _leaves(coeffs))


def thresholded_norm1(coeffs: Coeffs, beta, *, mode: str = "soft",
                      normalize: bool = False,
                      do_thresh_appcoeffs: bool = False) -> torch.Tensor:
    """``norm1(threshold(coeffs))`` without building the thresholded tree:
    soft gives sum max(|x| - b, 0), hard sum |x| [|x| > b], garrote
    sum (|x| - b^2 / |x|) [|x| > b].  ``beta`` is a scalar or a per-level
    (per-band) sequence, as for the threshold ops; ``mode`` is soft, hard
    or garrote."""
    from .threshold import _app_beta, _resolve_beta, beta_squared

    def term(x, b):
        ax = x.abs().to(_accum(x))
        if isinstance(b, torch.Tensor):
            b = b.to(ax.dtype)
        if mode == "soft":
            return torch.clamp_min(ax - b, 0).sum()
        if mode == "hard":
            return torch.where(ax > b, ax, 0.0).sum()
        if mode == "garrote":
            keep = ax > b
            safe = torch.where(keep, ax, 1.0)
            b2 = torch.as_tensor(beta_squared(b, ax), dtype=ax.dtype)
            return torch.where(keep, ax - b2 / safe, 0.0).sum()
        raise ValueError(f"thresholded_norm1 takes soft, hard or garrote, got {mode!r}")

    total = 0.0
    for i, j, x in detail_bands(coeffs):
        total = total + term(x, _resolve_beta(beta, i, j, normalize))
    a = coeffs.approx
    if do_thresh_appcoeffs:
        return total + term(a, _app_beta(beta, coeffs.levels, normalize))
    return total + a.abs().sum(dtype=_accum(a))
