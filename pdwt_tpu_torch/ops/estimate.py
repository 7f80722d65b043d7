"""Data-driven thresholds on coefficient trees, 3D, 2D or 1D, DWT or SWT
(counterpart of ``pdwt_tpu/ops/estimate.py``).

* :func:`noise_sigma`: Donoho and Johnstone's robust noise estimate, the
  median of |d| over the finest all-highpass band over Phi^-1(3/4);
* :func:`universal_threshold`: VisuShrink, sigma sqrt(2 ln N);
* :func:`bayes_thresholds`: BayesShrink, sigma^2 / sigma_x per band;
* :func:`sure_thresholds`: hybrid SureShrink per band.

Every result is a float32 tensor on the coefficients' device (the per-band
ones nested per level and per band, as the threshold ops take ``beta``):
nothing is read back to the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .threshold import Coeffs, _const

# 1/Phi^{-1}(3/4): MAD -> sigma for a Gaussian
_MAD_TO_SIGMA = 1.0 / 0.6744897501960817

F32 = torch.float32


def _finest_diag(coeffs: Coeffs) -> torch.Tensor:
    """The finest all-highpass band: ddd of level 1 in 3D, D in 2D, its
    detail in 1D."""
    det = coeffs.details[0]
    return det if isinstance(det, torch.Tensor) else det[-1]


def median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median of all of ``x``: the two middle values of the sorted
    values, (lo + hi) * 0.5 (equal for an odd count), NaN if any is NaN.
    ``torch.median`` gives the lower middle, and ``torch.quantile`` takes
    at most 2^24 values."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(s[-1]), s[-1], mid)  # a NaN sorts last


def noise_sigma(coeffs: Coeffs) -> torch.Tensor:
    """Robust noise standard deviation: median(|d|) * 1.4826 over the
    finest diagonal detail band."""
    d = _finest_diag(coeffs).to(F32)
    return median(d.abs()) * _const(_MAD_TO_SIGMA, d)


def _per_band(coeffs: Coeffs, band_t):
    """``band_t`` of every detail band, nested as the details are."""
    return tuple(band_t(det) if isinstance(det, torch.Tensor)
                 else tuple(band_t(b) for b in det) for det in coeffs.details)


def _detail_count(coeffs: Coeffs) -> int:
    return sum(b.numel() for det in coeffs.details
               for b in ((det,) if isinstance(det, torch.Tensor) else det))


def universal_threshold(coeffs: Coeffs, sigma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """VisuShrink's sigma * sqrt(2 ln N), N the number of detail
    coefficients; sigma defaults to :func:`noise_sigma`."""
    sigma = noise_sigma(coeffs) if sigma is None else torch.as_tensor(sigma)
    return sigma * _const(math.sqrt(2.0 * math.log(_detail_count(coeffs))), sigma)


def sure_risk(d: torch.Tensor, sigma: torch.Tensor):
    """(a, csum, risk) of one band: a = the sorted d^2, csum its float32
    cumulative sum, risk[k-1] = SURE(|d|_(k)) = n s2 - 2 s2 k + csum[k-1]
    + (n - k) a[k-1], the risk of the k-th smallest magnitude as the
    threshold."""
    s2 = sigma * sigma
    d = d.to(F32).reshape(-1)
    n = d.numel()
    a = torch.sort(d * d).values
    ks = torch.arange(1, n + 1, dtype=F32, device=d.device)
    csum = torch.cumsum(a, 0)
    return a, csum, n * s2 - 2.0 * s2 * ks + csum + (n - ks) * a


def sure_thresholds(coeffs: Coeffs, sigma: Optional[torch.Tensor] = None,
                    hybrid: bool = True):
    """SureShrink (Donoho and Johnstone 1995) soft threshold per band: the
    argmin of Stein's unbiased risk over {0} and the band's magnitudes,
    from one sort and one cumulative sum (:func:`sure_risk`).  With
    ``hybrid`` a band too sparse for SURE takes sigma sqrt(2 ln n).  Nested
    as :func:`bayes_thresholds`."""
    sigma = (noise_sigma(coeffs) if sigma is None else torch.as_tensor(sigma)).to(F32)
    s2 = sigma * sigma

    def band_t(d):
        n = d.numel()
        a, csum, risk = sure_risk(d, sigma)
        k = torch.argmin(risk)
        t_best = torch.where(risk[k] < n * s2, torch.sqrt(a[k]), 0.0)
        if not hybrid:
            return t_best
        t_univ = sigma * _const(math.sqrt(2.0 * math.log(max(n, 2))), sigma)
        # D&J 1995's sparsity test: SURE is unreliable where
        # sum(d^2 / s2 - 1) / n <= n^-1/2 ln(n)^3/2
        sparse = ((csum[-1] / s2 - n) / _const(n, sigma)
                  <= _const(n ** -0.5 * math.log(max(n, 2)) ** 1.5, sigma))
        return torch.where(sparse, t_univ, t_best)

    return _per_band(coeffs, band_t)


def bayes_thresholds(coeffs: Coeffs, sigma: Optional[torch.Tensor] = None):
    """BayesShrink (Chang, Yu and Vetterli 2000) soft threshold per band,
    sigma^2 / sigma_x with sigma_x^2 = max(E[d^2] - sigma^2, 0); a band with
    no estimated signal gets max|d|.  A tuple per level, of one per band
    in 2D: pass it as the ``beta`` of the threshold ops."""
    sigma = (noise_sigma(coeffs) if sigma is None else torch.as_tensor(sigma)).to(F32)
    s2 = sigma * sigma

    def band_t(d):
        d = d.to(F32)
        sx = torch.sqrt(torch.clamp_min(torch.sum(d * d) / _const(d.numel(), d) - s2, 0.0))
        pos = sx > 0
        return torch.where(pos, s2 / torch.where(pos, sx, 1.0), d.abs().max())

    return _per_band(coeffs, band_t)
