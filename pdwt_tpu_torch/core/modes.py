"""Boundary extension modes for the decimated DWT (counterpart of
``pdwt_tpu/core/modes.py``).

The full PyWavelets mode set, so pipelines written against
``pywt.wavedec*`` keep their boundary handling:

========================  ====================================================
``periodization``         the reference scheme (default): periodic wrap with
                          odd-size virtual extension, ``ceil(N/2)`` outputs
                          per level
``zero``                  ... 0 0 | x0 .. xN-1 | 0 0 ...
``constant``              ... x0 x0 | x | xN-1 xN-1 ...          (edge hold)
``symmetric``             ... x1 x0 | x | xN-1 xN-2 ...          (half-point)
``reflect``               ... x2 x1 | x | xN-2 xN-3 ...          (whole-point)
``periodic``              ... xN-2 xN-1 | x | x0 x1 ...  (wrap, pywt lengths)
``smooth``                linear extrapolation with the edge slope
``antisymmetric``         ... -x1 -x0 | x | -xN-1 -xN-2 ...  (half-point, odd)
``antireflect``           ... 2x0-x2 2x0-x1 | x | 2xN-1-xN-2 ... (whole-point,
                          odd: point reflection about the edge sample)
========================  ====================================================

Semantics follow the PyWavelets C implementation (true convolution
``out[m] = sum_j f[j] x_ext[2m+1-j]`` with ``floor((N+F-1)/2)`` outputs),
as the JAX package's module does.  The inverse needs no boundary extension:
it is a valid correlation of the zero-stuffed coefficients producing
``2M - F + 2`` samples, sliced to the stored next-level length.

An extension wider than one reflection period is a gather with affine edge
terms, ``ext[t] = s[t] * x[idx[t]] + a[t] * x[0] + b[t] * x[N-1]``, with the
index and sign maps made in numpy on the host (``_ext_maps``); narrower
ones are flips and slices of the edge strip, in the JAX module's order of
operations, so the two give the same values.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

MODES = (
    "periodization",
    "zero",
    "constant",
    "symmetric",
    "reflect",
    "periodic",
    "smooth",
    "antisymmetric",
    "antireflect",
)


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown boundary mode {mode!r}; expected one of {MODES}")
    return mode


def per_axis(mode, ndim: int):
    """One mode per transformed axis (pywt semantics: a string applies to
    every axis, a tuple or list gives one mode per axis in axis order, e.g.
    2D ``(row_mode, col_mode)``)."""
    if isinstance(mode, str):
        return (check_mode(mode),) * ndim
    modes = tuple(mode)
    if len(modes) != ndim:
        raise ValueError(f"expected {ndim} boundary modes (one per transformed axis), "
                         f"got {len(modes)}: {modes!r}")
    return tuple(check_mode(m) for m in modes)


def dec_len(n: int, hlen: int, mode: str = "periodization") -> int:
    """Per-level coefficient length: ``ceil(N/2)`` for periodization, the
    pywt rule ``floor((N + hlen - 1) / 2)`` for every other mode."""
    if mode == "periodization":
        return (n + 1) // 2
    return (n + hlen - 1) // 2


def rec_len(m: int, hlen: int, mode: str = "periodization") -> int:
    """Full inverse output length before slicing to the stored size."""
    if mode == "periodization":
        return 2 * m
    return 2 * m - hlen + 2


def level_sizes(n: int, levels: int, hlen: int, mode: str = "periodization") -> List[int]:
    """[n, dec_len(n), dec_len(dec_len(n)), ...], of length levels + 1."""
    sizes = [n]
    for _ in range(levels):
        sizes.append(dec_len(sizes[-1], hlen, mode))
    return sizes


def _ext_maps(n: int, pos: np.ndarray, mode: str):
    """(s, idx, a, b) float64/int maps such that ext[t] = s*x[idx] + a*x0 +
    b*x[N-1] is the pywt extension value at every position in ``pos``
    (integers outside [0, N))."""
    s = np.ones(pos.shape)
    a = np.zeros(pos.shape)
    b = np.zeros(pos.shape)
    if mode == "zero":
        return np.zeros(pos.shape), np.zeros(pos.shape, np.int64), a, b
    if mode == "constant":
        return s, np.where(pos < 0, 0, n - 1), a, b
    if mode == "periodic":
        return s, pos % n, a, b
    if mode in ("symmetric", "antisymmetric"):
        m = pos % (2 * n)
        idx = np.where(m < n, m, 2 * n - 1 - m)
        if mode == "antisymmetric":
            s = np.where(m < n, 1.0, -1.0)
        return s, idx, a, b
    if mode == "smooth":
        if n == 1:  # pywt falls back to edge replication
            return s, np.zeros(pos.shape, np.int64), a, b
        # left t<0: (1-t)*x0 + t*x1 ; right t>=N: x[N-1] + (t-N+1)*(x[N-1]-x[N-2])
        left = pos < 0
        idx = np.where(left, 1, n - 2)
        s = np.where(left, pos, -(pos - n + 1)).astype(np.float64)
        a = np.where(left, 1.0 - pos, 0.0)
        b = np.where(left, 0.0, pos - n + 2.0)
        return s, idx, a, b
    if mode in ("reflect", "antireflect"):
        if n < 2:
            raise ValueError(f"mode {mode!r} needs at least 2 samples along the axis")
        p = 2 * n - 2
        m = pos % p
        q = pos // p  # completed reflection periods (negative to the left)
        inner = m < n
        idx = np.where(inner, m, p - m)
        if mode == "reflect":
            return s, idx, a, b
        # antireflect: each period adds 2*(x[N-1] - x[0]); the reflected
        # half is point-mirrored about x[N-1] within its period
        s = np.where(inner, 1.0, -1.0)
        a = -2.0 * q.astype(np.float64)
        b = np.where(inner, 2.0 * q, 2.0 * q + 2.0)
        return s, idx, a, b
    raise ValueError(f"unknown boundary mode {mode!r}")


def _sl(x: torch.Tensor, axis: int, start: int, stop: int) -> torch.Tensor:
    return x.narrow(axis, start, stop - start)


def _shaped(v: np.ndarray, x: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis] = v.shape[0]
    return torch.as_tensor(v.reshape(shape), dtype=x.dtype, device=x.device)


def _rev_slice(x: torch.Tensor, axis: int, start: int, stop: int) -> torch.Tensor:
    """The edge strip [start, stop) along ``axis``, reversed."""
    return torch.flip(_sl(x, axis, start, stop), (axis,))


def _ext_block(x: torch.Tensor, axis: int, pos: np.ndarray, mode: str) -> torch.Tensor:
    n = x.shape[axis]
    w = pos.shape[0]
    left = bool(pos[0] < 0)
    # flips and slices of the edge strip for single-cycle widths
    if mode == "constant" or (mode == "smooth" and n == 1):
        edge = _sl(x, axis, 0, 1) if left else _sl(x, axis, n - 1, n)
        shape = list(x.shape)
        shape[axis] = w
        return edge.expand(shape)
    if mode in ("symmetric", "antisymmetric") and w <= n:
        strip = _rev_slice(x, axis, 0, w) if left else _rev_slice(x, axis, n - w, n)
        return -strip if mode == "antisymmetric" else strip
    if mode in ("reflect", "antireflect") and w <= n - 1:
        strip = (_rev_slice(x, axis, 1, w + 1) if left
                 else _rev_slice(x, axis, n - 1 - w, n - 1))
        if mode == "antireflect":
            edge = _sl(x, axis, 0, 1) if left else _sl(x, axis, n - 1, n)
            return 2.0 * edge - strip
        return strip
    if mode == "periodic" and w <= n:
        return _sl(x, axis, n - w, n) if left else _sl(x, axis, 0, w)
    if mode == "smooth":
        x0, x1 = _sl(x, axis, 0, 1), _sl(x, axis, 1, 2)
        xm, xp = _sl(x, axis, n - 1, n), _sl(x, axis, n - 2, n - 1)
        k = np.arange(1, w + 1, dtype=np.float64)
        k = _shaped(k[::-1].copy() if left else k, x, axis)
        return (x0 + k * (x0 - x1)) if left else (xm + k * (xm - xp))

    # pads wider than the signal (reflection cycling, antireflect's offset
    # build-up): the closed-form gather with affine edge terms
    s, idx, a, b = _ext_maps(n, pos, mode)
    if not s.any() and not a.any() and not b.any():
        shape = list(x.shape)
        shape[axis] = w
        return x.new_zeros(shape)
    out = None
    if s.any():
        g = torch.index_select(x, axis, torch.as_tensor(idx, dtype=torch.long, device=x.device))
        if not (s == 1.0).all():
            g = g * _shaped(s, x, axis)
        out = g
    if a.any():
        t = _sl(x, axis, 0, 1) * _shaped(a, x, axis)
        out = t if out is None else out + t
    if b.any():
        t = _sl(x, axis, n - 1, n) * _shaped(b, x, axis)
        out = t if out is None else out + t
    return out


def extend(x: torch.Tensor, axis: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Pad ``x`` along ``axis`` by ``lo``/``hi`` samples of the mode's
    boundary extension (pywt semantics, any width).  ``"periodization"``
    pads periodically here: its odd-size virtual extension is the
    transform's concern (``conv.odd_extend``)."""
    check_mode(mode)
    if mode == "periodization":
        mode = "periodic"
    axis = axis % x.ndim
    n = x.shape[axis]
    parts = []
    if lo:
        parts.append(_ext_block(x, axis, np.arange(-lo, 0), mode))
    parts.append(x)
    if hi:
        parts.append(_ext_block(x, axis, np.arange(n, n + hi), mode))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def zero_pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero padding along one axis (the non-periodization inverse pads the
    coefficients with zeros: no boundary extension)."""
    if lo == 0 and hi == 0:
        return x
    axis = axis % x.ndim
    parts = []
    for w in (lo, None, hi):
        if w is None:
            parts.append(x)
        elif w:
            shape = list(x.shape)
            shape[axis] = w
            parts.append(x.new_zeros(shape))
    return torch.cat(parts, dim=axis)
