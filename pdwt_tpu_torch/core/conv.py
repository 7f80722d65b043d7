"""Periodic filtering primitives: the port's single plain reference path.

Counterpart of the periodization, decimated part of
``pdwt_tpu/core/conv.py`` (its ``fma`` formulation).  The index spec is
the same:

Forward analysis::

    c  = fwd_center(hlen)
    xe = x extended by repeating the last element when N is odd
    out[n] = sum_j filt[hlen-1-j] * xe[(2n - c + j) mod Ne],  n in [0, Ne/2)

Inverse synthesis, stuff-free polyphase (see :func:`poly_geometry`)::

    out[2m + q] = sum_k sum_b rev_k[p_q + 2b] * x_k[(m + o_q + b) mod M]

with ``rev_k`` the reversed synthesis filter of band k.  That is the
correlation of the zero-stuffed coefficients with the reversed synthesis
filter at shift ``inv_shift(hlen)``, computed without the zeros.

Passes work on (B, C, H, W) tensors of float32 or float64.  The CUDA
kernels (``pdwt_tpu_torch/kernels``) read their offsets from
:func:`fwd_center` and :func:`poly_geometry`, so the index arithmetic is
defined here once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def fwd_center(hlen: int) -> int:
    """Analysis center tap."""
    return hlen // 2 if hlen % 2 else hlen // 2 - 1


def inv_shift(hlen: int) -> int:
    """Synthesis shift in the upsampled domain."""
    h2 = hlen // 2
    c2 = h2 // 2
    return 2 * c2 + 1 if h2 % 2 else 2 * c2


class PolyGeometry(NamedTuple):
    """Offsets of the stuff-free synthesis.  Output parity q uses the
    reversed taps ``p[q], p[q] + 2, ...`` (``nb[q]`` of them) on
    coefficients ``m + o[q] + b``; ``lo``/``hi`` are the periodic halo
    widths this needs below and above a coefficient window."""

    p: Tuple[int, int]
    o: Tuple[int, int]
    nb: Tuple[int, int]
    lo: int
    hi: int


def poly_geometry(hlen: int) -> PolyGeometry:
    s = inv_shift(hlen)
    p = (s % 2, 1 - s % 2)
    o = (-(s // 2), (1 - s + (1 - s % 2)) // 2)
    nb = tuple(len(range(p[q], hlen, 2)) for q in (0, 1))
    lo = max(0, -min(o))
    hi = max(0, max(o[q] + nb[q] - 1 for q in (0, 1)))
    return PolyGeometry(p, o, nb, lo, hi)


def _sl(x: torch.Tensor, ax: int, start: int, stop: int, step: int = 1):
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(start, stop, step)
    return x[tuple(idx)]


def odd_extend(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Repeat the last element when the size along ``axis`` is odd."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if n % 2 == 0:
        return x
    return torch.cat([x, _sl(x, ax, n - 1, n)], dim=ax)


def wrap_pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Periodic padding, also for pad widths larger than the axis."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if lo == 0 and hi == 0:
        return x
    parts = []
    if lo:
        full, rem = divmod(lo, n)
        if rem:
            parts.append(_sl(x, ax, n - rem, n))
        parts.extend([x] * full)
    parts.append(x)
    if hi:
        full, rem = divmod(hi, n)
        parts.extend([x] * full)
        if rem:
            parts.append(_sl(x, ax, 0, rem))
    return torch.cat(parts, dim=ax)


def _fma_analysis(xp: torch.Tensor, taps: np.ndarray, ax: int) -> torch.Tensor:
    """Correlate padded ``xp`` (B, C, H, W) with every row of ``taps``
    (K, hlen, already reversed) along ``ax``, decimating by 2 through an
    even/odd split.  Returns (B, C*K, ...)."""
    k, hlen = taps.shape
    n_out = (xp.shape[ax] - hlen) // 2 + 1
    n_pad = xp.shape[ax]
    even = _sl(xp, ax, 0, n_pad, 2)
    odd = _sl(xp, ax, 1, n_pad, 2)
    outs = []
    for kk in range(k):
        acc = None
        for j in range(hlen):
            src = even if j % 2 == 0 else odd
            term = float(taps[kk, j]) * _sl(src, ax, j // 2, j // 2 + n_out)
            acc = term if acc is None else acc + term
        outs.append(acc)
    out = torch.stack(outs, dim=2)  # (B, C, K, ...)
    b, c = out.shape[0], out.shape[1]
    return out.reshape((b, c * k) + tuple(out.shape[3:]))


def _fma_synthesis_poly(x: torch.Tensor, taps: np.ndarray, ax: int) -> torch.Tensor:
    """Stuff-free decimated synthesis: input (B, C*K, ...), where each
    group of K channels is combined into one output channel; each output
    parity is a half-length FIR over the coefficients and the two
    parities interleave."""
    k, hlen = taps.shape
    m = x.shape[ax]
    g = poly_geometry(hlen)
    ap = wrap_pad(x, ax, g.lo, g.hi)
    outs = []
    for q in (0, 1):
        acc = None
        for kk in range(k):
            src = ap[:, kk::k]
            for b, j in enumerate(range(g.p[q], hlen, 2)):
                start = g.lo + g.o[q] + b
                term = float(taps[kk, j]) * _sl(src, ax, start, start + m)
                acc = term if acc is None else acc + term
        outs.append(acc)
    y = torch.stack(outs, dim=ax + 1)
    shape = list(outs[0].shape)
    shape[ax] = 2 * m
    return y.reshape(shape)


def _check(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {x.dtype}")


def analysis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int
                  ) -> torch.Tensor:
    """Filter every channel of ``x`` (B, C, H, W) with each 1D filter
    along ``axis`` and decimate by 2 (periodization).  Returns
    (B, C*K, H', W') with output channel c*K + k = filter k applied to
    input channel c.  ``filters`` are forward-convention taps (e.g.
    ``dec_lo``); the reversal for correlation happens here."""
    _check(x)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    taps = np.stack([f[::-1] for f in filters])
    ax = axis % x.ndim
    c = fwd_center(hlen)
    xp = wrap_pad(odd_extend(x, ax), ax, c, hlen - 1 - c)
    return _fma_analysis(xp, taps, ax)


def synthesis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                   *, out_len: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`analysis_pass` along ``axis``: input
    (B, C*K, ...) -> (B, C, ...), output channel c summing the K filter
    syntheses of its group, sliced to ``out_len`` (odd sizes)."""
    _check(x)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    taps = np.stack([f[::-1] for f in filters])
    ax = axis % x.ndim
    out = _fma_synthesis_poly(x, taps, ax)
    if out_len is not None:
        out = _sl(out, ax, 0, out_len)
    return out
