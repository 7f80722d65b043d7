"""Starlet (isotropic undecimated a-trous) transform, 1D/2D/3D (counterpart
of ``pdwt_tpu/core/starlet.py``).

Smooth with the B3-spline kernel ``[1, 4, 6, 4, 1] / 16`` dilated a-trous
per level and keep the full-resolution differences as the detail planes:

    a_j = h_{2^(j-1)} * a_{j-1}          (separable, per axis)
    w_j = a_{j-1} - a_j                  (first generation), or
    w_j = a_{j-1} - h * a_j              (second generation)

Gen 1 inverts as ``x = a_J + sum_j w_j``, gen 2 level by level as
``a_{j-1} = h * a_j + w_j``.

Every pass is the lowpass-only stationary ``conv.analysis_pass`` (5 odd
taps), as JAX runs its fma passes here: JAX has no Pallas form of it
(``backend="pallas"`` maps to ``"fma"``), so the port has no kernel for it
either; ``backend=`` picks the passes' formulation (``core/conv.py``).
The passes take ``pad_fn`` for a sharded halo ring; the index semantics
are ``core/conv.py``'s (periodic, centered).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import conv

#: the cubic B3-spline smoothing kernel (Starck et al. eq. 1.13)
B3_SPLINE = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


class StarletCoeffs(NamedTuple):
    """``details[j]`` is the full-resolution detail plane of scale ``j+1``
    (finest first); ``approx`` is the coarsest smooth."""
    approx: torch.Tensor
    details: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


def _to_nc(x: torch.Tensor, sd: int):
    """(B, 1, *spatial) with a dummy row axis in 1D (the passes want at
    least two spatial axes), and the batch shape."""
    batch = tuple(x.shape[:-sd])
    if sd == 1:
        return x.reshape((-1, 1, 1) + tuple(x.shape[-1:])), batch
    return x.reshape((-1, 1) + tuple(x.shape[-sd:])), batch


def _smooth(a: torch.Tensor, sd: int, dilation: int, pad_fn, backend=None) -> torch.Tensor:
    """One B3 smoothing: the dilated lowpass along each of the ``sd``
    trailing axes."""
    for ax in range(-sd, 0):
        a = conv.analysis_pass(a, (B3_SPLINE,), axis=ax, dilation=dilation, decimate=False,
                               pad_fn=pad_fn, backend=backend)
    return a


def _pass_backend(backend: Optional[str]) -> Optional[str]:
    """The lowpass-only passes have no kernel form: ``"pallas"`` runs
    ``"fma"``."""
    return "fma" if backend == "pallas" else backend


def _check(ndim: int, gen: int) -> None:
    if gen not in (1, 2):
        raise ValueError(f"gen must be 1 or 2, got {gen}")
    if ndim not in (1, 2, 3):
        raise ValueError(f"ndim must be 1, 2 or 3, got {ndim}")


def starlet(x: torch.Tensor, levels: int, *, ndim: int = 2, gen: int = 2,
            backend: Optional[str] = None, pad_fn=None) -> StarletCoeffs:
    """Isotropic a-trous decomposition over the trailing ``ndim`` axes
    (leading axes are batch).  ``gen`` selects the detail definition (1:
    ``a_{j-1} - a_j``; 2: ``a_{j-1} - h*a_j``, the default)."""
    _check(ndim, gen)
    backend = _pass_backend(backend)
    arr, batch = _to_nc(x, ndim)
    spatial = tuple(x.shape[-ndim:])
    details = []
    a = arr
    for j in range(levels):
        nxt = _smooth(a, ndim, 1 << j, pad_fn, backend)
        ref = nxt if gen == 1 else _smooth(nxt, ndim, 1 << j, pad_fn, backend)
        details.append((a - ref).reshape(batch + spatial))
        a = nxt
    return StarletCoeffs(a.reshape(batch + spatial), tuple(details))


def istarlet(coeffs: StarletCoeffs, *, ndim: int = 2, gen: int = 2,
             backend: Optional[str] = None, pad_fn=None) -> torch.Tensor:
    """Exact inverse of :func:`starlet` (same ``gen``/``ndim``)."""
    if gen == 1:
        out = coeffs.approx
        for w in coeffs.details:
            out = out + w
        return out
    a, batch = _to_nc(coeffs.approx, ndim)
    spatial = tuple(coeffs.approx.shape[-ndim:])
    for j in range(len(coeffs.details) - 1, -1, -1):
        w, _ = _to_nc(coeffs.details[j], ndim)
        a = _smooth(a, ndim, 1 << j, pad_fn, _pass_backend(backend)) + w
    return a.reshape(batch + spatial)


@functools.lru_cache(maxsize=None)
def starlet_noise_gains(levels: int, ndim: int = 2, gen: int = 2) -> Tuple[float, ...]:
    """L2 norm of each detail plane's equivalent filter: the factor mapping
    white-noise sigma to the per-scale detail sigma (Starck et al. §6.3,
    computed for any levels/ndim/gen).  The scale-j detail kernel is the
    separable difference ``K_{j-1}^{(x)ndim} - R_j^{(x)ndim}`` (R = K_j for
    gen 1, h_j * K_j for gen 2), whose norm follows from 1D inner products:
    ``||A - B||^2 = <K,K>^n + <R,R>^n - 2 <K,R>^n``.  Pure numpy."""
    K = np.array([1.0])
    gains = []
    for j in range(levels):
        h = np.zeros(4 * (1 << j) + 1)
        h[:: 1 << j] = B3_SPLINE
        nxt = np.convolve(K, h)
        ref = nxt if gen == 1 else np.convolve(nxt, h)
        pad = (len(ref) - len(K)) // 2  # both odd, centered
        Kp = np.pad(K, pad)
        kk, rr, kr = Kp @ Kp, ref @ ref, Kp @ ref
        gains.append(float(np.sqrt(kk ** ndim + rr ** ndim - 2 * kr ** ndim)))
        K = nxt
    return tuple(gains)


def starlet_denoise(x: torch.Tensor, levels: int, beta, *, mode: str = "soft", ndim: int = 2,
                    gen: int = 2, backend: Optional[str] = None) -> torch.Tensor:
    """Threshold the starlet detail planes and reconstruct.  ``beta`` is a
    scalar or a per-level sequence (finest first)."""
    from ..ops.threshold import THR_ELEM

    thr = THR_ELEM[mode]
    c = starlet(x, levels, ndim=ndim, gen=gen, backend=backend)
    betas = list(beta) if isinstance(beta, (list, tuple)) else [beta] * levels
    if len(betas) != levels:
        raise ValueError(f"need {levels} betas, got {len(betas)}")
    details = tuple(thr(w, b) for w, b in zip(c.details, betas))
    return istarlet(StarletCoeffs(c.approx, details), ndim=ndim, gen=gen, backend=backend)
