"""The periodic depth pass of the 3D transforms as one matrix product
(counterpart of ``pdwt_tpu/core/depth_matmul.py``).

The depth (axis -3) filter pass is linear along depth: ``out = A @ x`` with
a small banded matrix ``A`` that holds the periodic wrap, the odd virtual
extension, the decimation or the a-trous dilation and the filter reversal
of ``core/conv.py``.  A depth-major volume is free to view as (B, D, R*C),
so the pass is one ``torch.matmul`` whose N dimension is the contiguous
plane: the volume is read once.

The matrices are built once in float64 numpy and cached per (taps, length,
dilation, decimation); each is kept on the device that asked for it, in
float64 for float64 data and in float32 otherwise.

Precision: JAX pins ``Precision.HIGHEST`` on float32 (exact float32
products), so the float32 product here runs with
``torch.set_float32_matmul_precision("highest")`` in force whatever the
caller set (TF32 keeps 10 mantissa bits and would move the exact tier by
about 1e-3 relative), forward and backward.  bfloat16 data is multiplied
as float32 by the float32 matrix and rounded to bfloat16 once, JAX's
``preferred_element_type=float32``; a bf16 product would round the taps.
The product's sum order differs from the conv passes', so the two agree
to float32 roundoff.

Sharded along depth, the pass cannot hold the wrap: the halo lives on the
ring neighbours.  :func:`depth_analysis_ring` and :func:`depth_synthesis_ring`
take the halo from a ``pad_fn`` (the ring exchange of
``parallel/halo.py``) and multiply the padded slab by a band matrix that
does not wrap, (D' x (D_local + halo)), still one product a subband: the
geometry ``conv.analysis_pass`` and ``conv.synthesis_pass`` pad by
(``fwd_center``, ``poly_geometry``, ``swt_inv_center``).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .conv import fwd_center, ieee_fp32, inv_shift, odd_extend, poly_geometry, swt_inv_center


def _ftup(f) -> Tuple[float, ...]:
    return tuple(float(v) for v in np.asarray(f, np.float64))


@functools.lru_cache(maxsize=None)
def analysis_matrix(taps: Tuple[Tuple[float, ...], ...], n: int, dilation: int,
                    decimate: bool) -> np.ndarray:
    """(K * n_out, n) matrix of the periodic analysis pass: row
    ``k * n_out + m`` computes output m of filter k.  ``taps`` are the
    forward-convention filters (reversed here, as ``conv.analysis_pass``
    reverses them)."""
    fs = [np.asarray(f, np.float64)[::-1] for f in taps]
    hlen = len(fs[0])
    c = fwd_center(hlen) * dilation
    ne = n + (n % 2) if decimate else n
    stride = 2 if decimate else 1
    n_out = ne // 2 if decimate else n
    a = np.zeros((len(fs), n_out, n))
    for m in range(n_out):
        for j in range(hlen):
            idx = (stride * m - c + j * dilation) % ne
            col = idx if idx < n else n - 1  # odd virtual extension
            for q, f in enumerate(fs):
                a[q, m, col] += f[j]
    a = a.reshape(len(fs) * n_out, n)
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=None)
def synthesis_matrix(taps: Tuple[Tuple[float, ...], ...], m: int, dilation: int,
                     decimated: bool, out_len: int) -> np.ndarray:
    """(out_len, K * m) matrix of the periodic synthesis pass of K
    coefficient bands (column ``k * m + t`` is coefficient t of band k),
    the spec of ``conv.synthesis_pass`` with the K bands of one group
    summed."""
    fs = [np.asarray(f, np.float64)[::-1] for f in taps]
    hlen = len(fs[0])
    if decimated:
        if dilation != 1:
            raise ValueError("the decimated pass takes no dilation")
        s, ln = inv_shift(hlen), 2 * m  # the zero-stuffed length
    else:
        s, ln = swt_inv_center(hlen) * dilation, m
    a = np.zeros((out_len, len(fs), m))
    for g in range(out_len):
        for j in range(hlen):
            idx = (g - s + j * dilation) % ln
            if decimated:
                if idx % 2:
                    continue  # a zero-stuffed slot
                idx //= 2
            for q, f in enumerate(fs):
                a[g, q, idx] += f[j]
    a = a.reshape(out_len, len(fs) * m)
    a.flags.writeable = False
    return a


def analysis_halo(hlen: int, dilation: int) -> Tuple[int, int]:
    """(lo, hi): the samples the analysis pass reads below and above its
    input, ``conv.analysis_pass``'s periodic pad."""
    c = fwd_center(hlen) * dilation
    return c, (hlen - 1) * dilation - c


def synthesis_halo(hlen: int, dilation: int, decimated: bool) -> Tuple[int, int]:
    """(lo, hi): the coefficients the synthesis pass reads below and above
    each band, ``conv.synthesis_pass``'s periodic pad."""
    if decimated:
        g = poly_geometry(hlen)
        return g.lo, g.hi
    s = swt_inv_center(hlen) * dilation
    return s, (hlen - 1) * dilation - s


@functools.lru_cache(maxsize=None)
def padded_analysis_matrix(taps: Tuple[Tuple[float, ...], ...], n: int, dilation: int,
                           decimate: bool) -> np.ndarray:
    """(K * n_out, n + lo + hi) matrix of the analysis pass of ``n`` (even
    when decimated) samples padded by :func:`analysis_halo`: row ``k * n_out
    + m`` computes output m of filter k from padded samples ``stride * m + j
    * dilation``, no wrap."""
    fs = [np.asarray(f, np.float64)[::-1] for f in taps]
    hlen = len(fs[0])
    lo, hi = analysis_halo(hlen, dilation)
    stride = 2 if decimate else 1
    n_out = n // stride
    a = np.zeros((len(fs), n_out, n + lo + hi))
    for m in range(n_out):
        for j in range(hlen):
            for q, f in enumerate(fs):
                a[q, m, stride * m + j * dilation] += f[j]
    a = a.reshape(len(fs) * n_out, n + lo + hi)
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=None)
def padded_synthesis_matrix(taps: Tuple[Tuple[float, ...], ...], m: int, dilation: int,
                            decimated: bool, out_len: int) -> np.ndarray:
    """(out_len, K * (m + lo + hi)) matrix of the synthesis of K bands of
    ``m`` coefficients, each padded by :func:`synthesis_halo` (column ``k *
    (m + lo + hi) + t`` is padded coefficient t of band k), no wrap: the
    polyphase form of ``conv.synthesis_pass`` decimated, its dilated
    correlation otherwise."""
    fs = [np.asarray(f, np.float64)[::-1] for f in taps]
    hlen = len(fs[0])
    lo, hi = synthesis_halo(hlen, dilation, decimated)
    mp = m + lo + hi
    a = np.zeros((out_len, len(fs), mp))
    if decimated:
        g = poly_geometry(hlen)
        for e in range(out_len):
            mm, q = divmod(e, 2)
            for b, j in enumerate(range(g.p[q], hlen, 2)):
                for k, f in enumerate(fs):
                    a[e, k, lo + g.o[q] + b + mm] += f[j]
    else:
        for e in range(out_len):
            for j in range(hlen):
                for k, f in enumerate(fs):
                    a[e, k, e + j * dilation] += f[j]
    a = a.reshape(out_len, len(fs) * mp)
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=256)
def _on(make, args, parts: int, dtype: torch.dtype, device: str) -> Tuple[torch.Tensor, ...]:
    mat = torch.from_numpy(np.array(make(*args))).to(device=device, dtype=dtype)
    return tuple(t.contiguous() for t in mat.chunk(parts, dim=1))


def _matrices(make, args, parts: int, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The matrix on ``x``'s device, float64 for float64 data and float32
    otherwise, split by columns into ``parts`` contiguous blocks."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return _on(make, args, parts, dt, str(x.device))


def _products(mats, xs) -> torch.Tensor:
    """sum_k mats[k] @ xs[k] over (B, Dk, N) views, summed in float32 (or
    float64) and rounded once to the inputs' dtype: the first product
    allocates the output, the others accumulate into it (``baddbmm_``,
    beta 1), so no input is copied to stack it."""
    dt = xs[0].dtype
    with ieee_fp32():
        y = None
        for mat, x in zip(mats, xs):
            xw = x.float() if dt == torch.bfloat16 else x
            if y is None:
                y = torch.matmul(mat, xw)
            else:
                y.baddbmm_(mat.expand(xw.shape[0], -1, -1), xw)
    return y.to(dt)


class _DepthProduct(torch.autograd.Function):
    """``sum_k mats[k] @ xs[k]`` with the precision above both ways; the
    matrices are constants."""

    @staticmethod
    def forward(ctx, mats, *xs):
        ctx.mats = mats
        return _products(mats, xs)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return (None, *(_products((m.t(),), (g,)) for m in ctx.mats))


def depth_analysis_mm(x: torch.Tensor, filters: Sequence, *, dilation: int = 1,
                      decimate: bool = True) -> torch.Tensor:
    """The periodic depth analysis of ``x`` (B, D, R, C) by each filter:
    (B, K, D', R, C), channel k filter k; D' = ceil(D / 2) decimated, else
    D.  The spec of ``conv.analysis_pass(x[:, None], filters, axis=-3, ...)``
    (one ``torch.matmul``)."""
    b, d, r, c = x.shape
    taps = tuple(_ftup(f) for f in filters)
    mats = _matrices(analysis_matrix, (taps, d, dilation, bool(decimate)), 1, x)
    y = _DepthProduct.apply(mats, x.reshape(b, d, r * c))
    k = len(taps)
    return y.reshape(b, k, y.shape[1] // k, r, c)


def depth_synthesis_mm(bands: Sequence[torch.Tensor], filters: Sequence, *, out_len: int,
                       dilation: int = 1, decimated: bool = True) -> torch.Tensor:
    """The periodic depth synthesis of one group of K bands (each
    (B, M, R, C), band k for filter k) into (B, out_len, R, C): the spec of
    ``conv.synthesis_pass`` on the K channels stacked, reading each band
    where it lies (one product per band)."""
    b, m, r, c = bands[0].shape
    taps = tuple(_ftup(f) for f in filters)
    mats = _matrices(synthesis_matrix, (taps, m, dilation, bool(decimated), out_len),
                     len(taps), bands[0])
    y = _DepthProduct.apply(mats, *(t.reshape(b, m, r * c) for t in bands))
    return y.reshape(b, out_len, r, c)


def depth_analysis_ring(x: torch.Tensor, filters: Sequence, *, pad_fn, dilation: int = 1,
                        decimate: bool = True) -> torch.Tensor:
    """:func:`depth_analysis_mm` of a depth shard: ``x`` (B, D, R, C) odd-
    extended (decimated), its depth halo fetched by ``pad_fn(x, 1, lo,
    hi)`` (the ring exchange; ``wrap_pad`` on one shard), then one product
    by :func:`padded_analysis_matrix`.  The spec of
    ``conv.analysis_pass(x[:, None], filters, axis=-3, pad_fn=pad_fn,
    ...)``."""
    if decimate:
        x = odd_extend(x, 1)
    b, d, r, c = x.shape
    taps = tuple(_ftup(f) for f in filters)
    xp = pad_fn(x, 1, *analysis_halo(len(taps[0]), dilation)).contiguous()
    mats = _matrices(padded_analysis_matrix, (taps, d, dilation, bool(decimate)), 1, x)
    y = _DepthProduct.apply(mats, xp.reshape(b, xp.shape[1], r * c))
    k = len(taps)
    return y.reshape(b, k, y.shape[1] // k, r, c)


def depth_synthesis_ring(bands: Sequence[torch.Tensor], filters: Sequence, *, pad_fn,
                         out_len: int, dilation: int = 1, decimated: bool = True
                         ) -> torch.Tensor:
    """:func:`depth_synthesis_mm` of depth shards: each band (B, M, R, C)
    padded by ``pad_fn(t, 1, lo, hi)`` (the ring exchange), then one product
    a band by its block of :func:`padded_synthesis_matrix`, summed.  The
    spec of ``conv.synthesis_pass`` along depth with ``pad_fn``."""
    b, m, r, c = bands[0].shape
    taps = tuple(_ftup(f) for f in filters)
    lo, hi = synthesis_halo(len(taps[0]), dilation, decimated)
    mats = _matrices(padded_synthesis_matrix, (taps, m, dilation, bool(decimated), out_len),
                     len(taps), bands[0])
    ps = [pad_fn(t, 1, lo, hi).contiguous() for t in bands]
    y = _DepthProduct.apply(mats, *(t.reshape(b, t.shape[1], r * c) for t in ps))
    return y.reshape(b, out_len, r, c)
