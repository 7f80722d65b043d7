"""Filtering primitives: the port's single plain reference path.

Counterpart of ``pdwt_tpu/core/conv.py`` (its ``fma`` formulation).  The
index spec of periodization, the default, is the same:

Forward analysis::

    c  = fwd_center(hlen)
    xe = x extended by repeating the last element when N is odd
    out[n] = sum_j filt[hlen-1-j] * xe[(2n - c + j) mod Ne],  n in [0, Ne/2)

Inverse synthesis, stuff-free polyphase (see :func:`poly_geometry`)::

    out[2m + q] = sum_k sum_b rev_k[p_q + 2b] * x_k[(m + o_q + b) mod M]

with ``rev_k`` the reversed synthesis filter of band k.  That is the
correlation of the zero-stuffed coefficients with the reversed synthesis
filter at shift ``inv_shift(hlen)``, computed without the zeros.

Stationary (a-trous) passes, ``decimate=False`` / ``decimated=False``:
stride 1, taps dilated by ``f = 2^(level-1)``::

    analysis   out[n] = sum_j filt[hlen-1-j] * x[(n - c*f + j*f) mod N]
    synthesis  out[n] = sum_k sum_j rev_k[j] * x_k[(n - s*f + j*f) mod N]

with ``c = fwd_center(hlen)`` and ``s = swt_inv_center(hlen)``; the caller
folds the synthesis's 1/2 per pass into the filters.

The other boundary modes (``core/modes.py``, decimated passes only) follow
pywt: the analysis is a valid decimating correlation over the signal
extended by (hlen - 2, hlen - 1) samples, ``floor((N + hlen - 1) / 2)``
outputs; the synthesis is the polyphase form at shift 1 over zero-padded
coefficients, ``2M - hlen + 2`` outputs (even ``hlen`` only), sliced to the
stored length.  bfloat16 passes of a mode sum in float32 and round once
per pass, as JAX's fma formulation does.

Passes work on (B, C, H, W) tensors of float32 or float64.  The CUDA
kernels (``pdwt_tpu_torch/kernels``) read their offsets from
:func:`fwd_center` and :func:`poly_geometry`, so the index arithmetic is
defined here once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import modes


def fwd_center(hlen: int) -> int:
    """Analysis center tap."""
    return hlen // 2 if hlen % 2 else hlen // 2 - 1


def inv_shift(hlen: int) -> int:
    """Synthesis shift in the upsampled domain."""
    h2 = hlen // 2
    c2 = h2 // 2
    return 2 * c2 + 1 if h2 % 2 else 2 * c2


def swt_inv_center(hlen: int) -> int:
    """Stationary synthesis center (before dilation)."""
    return hlen // 2


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


def poly_geometry(hlen: int, s: Optional[int] = None) -> PolyGeometry:
    """The offsets of the synthesis at shift ``s`` (``inv_shift(hlen)``,
    periodization's, by default; pywt's modes take 1)."""
    s = inv_shift(hlen) if s is None else s
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


def _fma_analysis(xp: torch.Tensor, taps: np.ndarray, ax: int, *,
                  decimate: bool = True, dilation: int = 1) -> torch.Tensor:
    """Correlate padded ``xp`` (B, C, H, W) with every row of ``taps``
    (K, hlen, already reversed) along ``ax``: decimating by 2 through an
    even/odd split, or at stride 1 with the taps ``dilation`` apart.
    Returns (B, C*K, ...)."""
    k, hlen = taps.shape
    n_pad = xp.shape[ax]
    if decimate:
        n_out = (n_pad - hlen) // 2 + 1
        even = _sl(xp, ax, 0, n_pad, 2)
        odd = _sl(xp, ax, 1, n_pad, 2)
        term = lambda j: _sl(even if j % 2 == 0 else odd, ax, j // 2, j // 2 + n_out)
    else:
        n_out = n_pad - (hlen - 1) * dilation
        term = lambda j: _sl(xp, ax, j * dilation, j * dilation + n_out)
    outs = []
    for kk in range(k):
        acc = None
        for j in range(hlen):
            t = float(taps[kk, j]) * term(j)
            acc = t if acc is None else acc + t
        outs.append(acc)
    out = torch.stack(outs, dim=2)  # (B, C, K, ...)
    b, c = out.shape[0], out.shape[1]
    return out.reshape((b, c * k) + tuple(out.shape[3:]))


def _fma_synthesis_poly(x: torch.Tensor, taps: np.ndarray, ax: int, pad_fn=wrap_pad,
                        s: Optional[int] = None) -> torch.Tensor:
    """Stuff-free decimated synthesis at shift ``s`` (see
    :func:`poly_geometry`) over ``x`` padded by ``pad_fn``: input
    (B, C*K, ...), where each group of K channels is combined into one
    output channel; each output parity is a half-length FIR over the
    coefficients and the two parities interleave."""
    k, hlen = taps.shape
    m = x.shape[ax]
    g = poly_geometry(hlen, s)
    ap = pad_fn(x, ax, g.lo, g.hi)
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


def _fma_synthesis(up: torch.Tensor, taps: np.ndarray, ax: int, dilation: int
                   ) -> torch.Tensor:
    """Stationary synthesis of padded ``up`` (B, C*K, ...): output channel c
    sums the K dilated correlations of its group."""
    k, hlen = taps.shape
    n_out = up.shape[ax] - (hlen - 1) * dilation
    acc = None
    for kk in range(k):
        src = up[:, kk::k]
        for j in range(hlen):
            t = float(taps[kk, j]) * _sl(src, ax, j * dilation, j * dilation + n_out)
            acc = t if acc is None else acc + t
    return acc


def _check(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"expected float32 or float64 (or bfloat16), got {x.dtype}")


def _acc(x: torch.Tensor) -> torch.Tensor:
    """The pass's working dtype: float32 for bfloat16 data."""
    return x.float() if x.dtype == torch.bfloat16 else x


def analysis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int, *,
                  dilation: int = 1, decimate: bool = True,
                  mode: str = "periodization", pad_fn=None) -> torch.Tensor:
    """Filter every channel of ``x`` (B, C, H, W) with each 1D filter
    along ``axis``: decimated by 2, or stationary with the taps
    ``dilation`` apart (``decimate=False``).  Returns (B, C*K, H', W')
    with output channel c*K + k = filter k applied to input channel c.
    ``filters`` are forward-convention taps (e.g. ``dec_lo``); the reversal
    for correlation happens here.  ``mode`` is the boundary extension
    (``core/modes.py``): periodization by default; the pywt modes apply to
    the decimated pass only and give ``floor((N + hlen - 1) / 2)``
    outputs.  bfloat16 data is summed in float32 and rounded once, as
    JAX's fma formulation does.  ``pad_fn(x, axis, lo, hi)`` replaces the
    periodic pad (:func:`wrap_pad`): the sharded transforms pass the ring
    halo exchange (``pdwt_tpu_torch/parallel/halo.py``); it takes
    periodization only."""
    _check(x)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    ax = axis % x.ndim
    if decimate and dilation != 1:
        raise ValueError("the decimated pass takes no dilation")
    if mode != "periodization":
        modes.check_mode(mode)
        if not decimate:
            raise ValueError("boundary modes other than 'periodization' apply to the "
                             "decimated DWT only (pywt's swt is periodic by definition)")
        if pad_fn is not None:
            raise ValueError("sharded halo exchange (pad_fn) requires mode='periodization'")
        # out[m] = sum_j f[j] x_ext[2m+1-j] (pywt's downsampling convolution):
        # a valid correlation of the reversed taps over x extended by
        # (hlen - 2, hlen - 1)
        xp = modes.extend(x, ax, hlen - 2, hlen - 1, mode)
        return padded_analysis_pass(_acc(xp), filters, ax).to(x.dtype)
    c = fwd_center(hlen) * dilation
    xe = odd_extend(x, ax) if decimate else x
    xp = (pad_fn or wrap_pad)(_acc(xe), ax, c, (hlen - 1) * dilation - c)
    taps = np.stack([f[::-1] for f in filters])
    return _fma_analysis(xp, taps, ax, decimate=decimate, dilation=dilation).to(x.dtype)


def synthesis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                   *, out_len: Optional[int] = None, dilation: int = 1,
                   decimated: bool = True, mode: str = "periodization",
                   pad_fn=None) -> torch.Tensor:
    """Inverse of :func:`analysis_pass` along ``axis``: input
    (B, C*K, ...) -> (B, C, ...), output channel c summing the K filter
    syntheses of its group, sliced to ``out_len`` (odd sizes).
    ``decimated=False`` is the stationary synthesis at
    ``swt_inv_center(hlen) * dilation``; the caller scales the filters by
    the 1/2 per pass.  A pywt ``mode`` takes no boundary extension: zero
    pads and shift 1, ``rec_len`` outputs at most, an even ``hlen``.
    ``pad_fn``: as in :func:`analysis_pass`."""
    _check(x)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    taps = np.stack([f[::-1] for f in filters])
    ax = axis % x.ndim
    if decimated and dilation != 1:
        raise ValueError("the decimated pass takes no dilation")
    if mode != "periodization":
        modes.check_mode(mode)
        if not decimated:
            raise ValueError("boundary modes other than 'periodization' apply to the "
                             "decimated inverse DWT only")
        if pad_fn is not None:
            raise ValueError("sharded halo exchange (pad_fn) requires mode='periodization'")
        out_len = mode_out_len(x.shape[ax], hlen, mode, out_len)
        # pywt's upsampling_convolution_valid_sf: shift 1, no extension
        return padded_synthesis_pass(_acc(x), filters, ax, -1, out_len).to(x.dtype)
    xa, pad_fn = _acc(x), pad_fn or wrap_pad
    if decimated:
        out = _fma_synthesis_poly(xa, taps, ax, pad_fn)
    else:
        s = swt_inv_center(hlen) * dilation
        out = _fma_synthesis(pad_fn(xa, ax, s, (hlen - 1) * dilation - s), taps, ax,
                             dilation)
    if out_len is not None:
        out = _sl(out, ax, 0, out_len)
    return out.to(x.dtype)


def mode_out_len(m: int, hlen: int, mode: str, out_len: Optional[int]) -> int:
    """The output length of a pywt mode's synthesis of ``m`` coefficients
    (``out_len``, or the full ``rec_len`` when None); raises on an odd
    filter length (pywt's parity rule) and on an ``out_len`` past
    ``rec_len``."""
    if hlen % 2:
        raise ValueError("non-periodization inverse requires an even filter length "
                         "(pywt upsampling_convolution_valid_sf parity)")
    full = modes.rec_len(m, hlen, mode)
    if out_len is None:
        return full
    if out_len > full:
        raise ValueError(f"out_len {out_len} exceeds the mode's full inverse length {full}")
    return out_len


# ---------------------------------------------------------------------------
# the passes on an input that holds its boundary: the plain versions of the
# padded kernel entry points, and the pywt modes' passes
# ---------------------------------------------------------------------------

def padded_analysis_pass(xp: torch.Tensor, filters: Sequence[np.ndarray],
                         axis: int) -> torch.Tensor:
    """The decimated analysis of ``xp`` (B, C, H, W), which holds its
    boundary extension along ``axis``: a valid correlation, no wrap,
    ``out[n] = sum_j f[hlen-1-j] xp[2n + j]`` for the ``(N - hlen) // 2 + 1``
    outputs that the N samples hold.  Returns (B, C*K, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    ax = axis % xp.ndim
    padded_len(xp.shape[ax], len(filters[0]))
    return _fma_analysis(xp, np.stack([f[::-1] for f in filters]), ax)


def padded_len(n: int, hlen: int) -> int:
    """The outputs of :func:`padded_analysis_pass` along an axis of ``n``
    samples that hold their extension; raises below one."""
    if n < hlen:
        raise ValueError(f"a padded analysis of {hlen} taps needs at least {hlen} samples "
                         f"along the axis, got {n}")
    return (n - hlen) // 2 + 1


def check_padded_synthesis(n: int, hlen: int, c0: int, out_len: int) -> None:
    """Raise unless the ``out_len`` outputs of :func:`padded_synthesis_pass`
    at offset ``c0`` read only the ``n`` coefficients they are given: its
    even positions ``i + c0 + j`` run from ``c0`` (rounded up) to
    ``out_len + c0 + hlen - 2``, coefficient ``position / 2``."""
    if out_len < 1 or c0 < -1 or (out_len + c0 + hlen - 2) // 2 > n - 1:
        raise ValueError(f"a padded synthesis of {out_len} outputs at offset {c0} with "
                         f"{hlen} taps reads outside its {n} coefficients")


def padded_synthesis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                          c0: int, out_len: int) -> torch.Tensor:
    """The decimated synthesis of ``x`` (B, C*K, ...), which holds its
    boundary (zeros, or the periodic halo) along ``axis``, with no wrap:
    ``out[i] = sum_k sum_j rev_k[j] * U_k[i + c0 + j]`` for ``i < out_len``,
    ``U_k`` the zero-stuffed band k (``U_k[2e] = x_k[e]``), ``rev_k`` the
    reversed filter k; every coefficient it reads must lie in ``x``
    (:func:`check_padded_synthesis`).  pywt's modes take ``c0 = -1``; a
    periodization axis padded by ``poly_geometry(hlen).lo`` takes ``2 lo -
    inv_shift(hlen)``.  Returns (B, C, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    ax = axis % x.ndim
    check_padded_synthesis(x.shape[ax], hlen, c0, out_len)
    taps = np.stack([f[::-1] for f in filters])
    out = _fma_synthesis_poly(x, taps, ax, pad_fn=modes.zero_pad, s=-c0)
    return _sl(out, ax, 0, out_len)


def padded_atrous_len(n: int, hlen: int, f: int) -> int:
    """The outputs of the padded a-trous passes along an axis of ``n``
    samples that hold their halo, ``n - (hlen - 1) f``; raises below one."""
    span = (hlen - 1) * f
    if n <= span:
        raise ValueError(f"a padded a-trous pass of {hlen} taps at dilation {f} needs more "
                         f"than {span} samples along the axis, got {n}")
    return n - span


def padded_atrous_analysis_pass(xp: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                                dilation: int) -> torch.Tensor:
    """The a-trous analysis of ``xp`` (B, C, H, W), which holds its halo
    along ``axis`` (the periodic one is ``fwd_center(hlen) * f`` below and
    the rest of the span above): a valid correlation, no wrap, ``out[n] =
    sum_j f[hlen-1-j] xp[n + j f]`` for the :func:`padded_atrous_len`
    outputs.  Returns (B, C*K, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    ax = axis % xp.ndim
    padded_atrous_len(xp.shape[ax], len(filters[0]), dilation)
    return _fma_analysis(xp, np.stack([f[::-1] for f in filters]), ax, decimate=False,
                         dilation=dilation)


def padded_atrous_synthesis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                                 dilation: int) -> torch.Tensor:
    """The a-trous synthesis of ``x`` (B, C*K, ...), which holds its halo
    along ``axis`` (the periodic one is ``swt_inv_center(hlen) * f`` below):
    ``out[n] = sum_k sum_j rev_k[j] x_k[n + j f]``, no wrap, for the
    :func:`padded_atrous_len` outputs; the caller folds the 1/2 per pass
    into the filters.  Returns (B, C, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    ax = axis % x.ndim
    padded_atrous_len(x.shape[ax], len(filters[0]), dilation)
    return _fma_synthesis(x, np.stack([f[::-1] for f in filters]), ax, dilation)
