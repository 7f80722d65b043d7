"""Banded-product level kernels of the precision tiers, batched 1D:
wrappers, plain versions, gradients and the route rule.

Counterpart of ``pdwt_tpu/kernels/mxu1d_pallas.py`` (kernels 15 and 16).
Each level is one pass along the last axis of a (B, N) batch, under a
compute scheme of ``kernels/matmul.py`` (its docstring states each
scheme's arithmetic).  The kernels of ``csrc/mxu1d.cu`` (per direction one
that stages its window in shared memory, and one for windows past it)
take four wrappers:

==========================  ======================================  ==============
wrapper                     computes                                kernel
==========================  ======================================  ==============
``fwd_level_1d_mxu``        decimated analysis, (B, N) -> 2 (B, N/2)  analysis
``swt_fwd_level_1d_mxu``    a-trous analysis at dilation f          analysis
``inv_level_1d_mxu``        polyphase synthesis, 2 (B, M) -> (B, 2M)  synthesis
``swt_inv_level_1d_mxu``    a-trous synthesis, one 1/2 in the taps  synthesis
==========================  ======================================  ==============

The low band is float32; the high band is float32 or bf16 (the bf16
tiers' detail dtype).  The a-trous synthesis folds its 1/2 into the taps
before they are rounded (``mxu1d_pallas.py:88-98``).  Each wrapper's plain
version is ``<wrapper>_ref``, built on ``core/conv.py``; a wrapper given a
CPU tensor returns it, given a CUDA tensor it launches its kernel or
raises.  Gradients (``mxu1d_pallas.py:342-451``): the paired wrapper with
reversed taps (a-trous: ``2 * rev`` and ``0.5 * rev``) in the same mode,
its output in the forward input's dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import conv
from ._launch import check_span, dilation, launch, on_cpu, poly_geo, ptr, rev
from .matmul import (_DT, BF16, F32, MXU_COLS, MXU_MAX_HLEN, SCHEMES, _check_scheme, _is_bf16,
                     inv_plan, kernel_taps, mode_out_dtypes, mode_scheme, scheme_pass,
                     swt_scheme)

#: batch divisor of the 1D route (the smallest TB of _pick_1d_tiles)
MXU_BATCH = 16


def mxu_route_1d(B: int, n: int, hlen: int, level: Optional[int] = None) -> bool:
    """Does a batched-1D level of ``B`` signals of length ``n`` (the input
    of the forward, the output of the inverse) take the banded-product
    kernels?  The gate of ``_pick_1d_tiles`` and the geometry checks of
    ``mxu1d_pallas.py:211-331``: an even filter of at most 40 taps, B a
    multiple of 16 and an output length per signal that is a multiple of
    128 (N/2 for the decimated pair, N even; N for the a-trous pair, whose
    dilated span must also fit twice the column tile, ``level`` given)."""
    if hlen % 2 or hlen > MXU_MAX_HLEN or B % MXU_BATCH:
        return False
    if level is None:
        return n % 2 == 0 and (n // 2) % MXU_COLS == 0
    tc = 256 if n % 256 == 0 else 128
    return n % MXU_COLS == 0 and (hlen - 1) * dilation(level) <= 2 * tc


def _half(f) -> np.ndarray:
    return 0.5 * np.asarray(f, dtype=np.float64)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _fwd_ref(x, dec_lo, dec_hi, scheme, hi_dtype, **kw):
    _check_scheme(scheme)
    z = scheme_pass(x[:, None, None], (dec_lo, dec_hi), scheme,
                    lambda d, f: conv.analysis_pass(d, f, axis=-1, **kw))
    return z[:, 0, 0].contiguous(), z[:, 1, 0].to(hi_dtype).contiguous()


def _inv_ref(lo, hi, filters, scheme, out_dtype, **kw):
    _check_scheme(scheme)
    z = torch.stack([lo.float(), hi.float()], dim=1)[:, :, None]
    y = scheme_pass(z, filters, scheme, lambda u, f: conv.synthesis_pass(u, f, axis=-1, **kw))
    return y[:, 0, 0].to(out_dtype).contiguous()


def fwd_level_1d_mxu_ref(x, dec_lo, dec_hi, scheme: str, hi_dtype=F32):
    """Decimated analysis, (B, N) -> (lo float32, hi ``hi_dtype``), each (B, N/2)."""
    return _fwd_ref(x, dec_lo, dec_hi, scheme, hi_dtype)


def swt_fwd_level_1d_mxu_ref(x, dec_lo, dec_hi, level: int, scheme: str, hi_dtype=F32):
    """A-trous analysis at level ``level``, (B, N) -> two (B, N)."""
    return _fwd_ref(x, dec_lo, dec_hi, scheme, hi_dtype, dilation=dilation(level),
                    decimate=False)


def inv_level_1d_mxu_ref(lo, hi, rec_lo, rec_hi, scheme: str, out_dtype=F32):
    """Polyphase synthesis, 2 x (B, M) -> (B, 2M)."""
    return _inv_ref(lo, hi, (rec_lo, rec_hi), scheme, out_dtype)


def swt_inv_level_1d_mxu_ref(lo, hi, rec_lo, rec_hi, level: int, scheme: str, out_dtype=F32):
    """A-trous synthesis with one 1/2, 2 x (B, N) -> (B, N)."""
    return _inv_ref(lo, hi, (_half(rec_lo), _half(rec_hi)), scheme, out_dtype,
                    dilation=dilation(level), decimated=False)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _fwd_launch(name, x, filters, scheme, hi_dtype, n_out, f, cen):
    _check_scheme(scheme)
    B, n = x.shape
    tp = kernel_taps(filters, scheme)
    check_span(len(tp[0]), f)
    lo = torch.empty((B, n_out), device=x.device, dtype=F32)
    hi = torch.empty((B, n_out), device=x.device, dtype=hi_dtype)
    launch(name, x.device,
           [ptr(x), ptr(lo), ptr(hi), B, n, *map(ptr, tp), len(tp[0]), f, cen,
            SCHEMES.index(scheme), _is_bf16(x.dtype), _is_bf16(hi_dtype)])
    return lo, hi


def _inv_launch(name, lo, hi, filters, scheme, out_dtype, n_out, f, cen):
    _check_scheme(scheme)
    if lo.shape != hi.shape:
        raise ValueError(f"the two bands must have one shape, got {tuple(lo.shape)} "
                         f"and {tuple(hi.shape)}")
    if lo.dtype != F32:
        raise ValueError("the banded-product kernels take a float32 low band")
    B, m = lo.shape
    tp = kernel_taps(filters, scheme)
    check_span(len(tp[0]), f)
    out = torch.empty((B, n_out), device=lo.device, dtype=out_dtype)
    geo = poly_geo(len(tp[0]))  # read by the polyphase kernel only
    launch(name, lo.device,
           [ptr(lo), ptr(hi), ptr(out), B, m, *map(ptr, tp), len(tp[0]), f, cen, ptr(geo),
            SCHEMES.index(scheme), _is_bf16(hi.dtype), _is_bf16(out_dtype)])
    return out


def fwd_level_1d_mxu(x: torch.Tensor, dec_lo, dec_hi, scheme: str, hi_dtype=F32):
    """Decimated analysis on (B, N), N even, float32 or bf16 -> (lo, hi),
    each (B, N/2); lo float32, hi ``hi_dtype``."""
    if on_cpu(x, ndim=2, dtypes=_DT):
        return fwd_level_1d_mxu_ref(x, dec_lo, dec_hi, scheme, hi_dtype)
    B, n = x.shape
    if n % 2:
        raise ValueError(f"fwd_level_1d_mxu takes an even length, got {n}")
    return _fwd_launch("fwd_level_1d_mxu", x, (dec_lo, dec_hi), scheme, hi_dtype, n // 2, 1,
                       conv.fwd_center(len(dec_lo)))


def swt_fwd_level_1d_mxu(x: torch.Tensor, dec_lo, dec_hi, level: int, scheme: str,
                         hi_dtype=F32):
    """A-trous analysis on (B, N), any N -> (lo, hi), each (B, N)."""
    if on_cpu(x, ndim=2, dtypes=_DT):
        return swt_fwd_level_1d_mxu_ref(x, dec_lo, dec_hi, level, scheme, hi_dtype)
    f = dilation(level)
    return _fwd_launch("swt_fwd_level_1d_mxu", x, (dec_lo, dec_hi), scheme, hi_dtype,
                       x.shape[1], f, conv.fwd_center(len(dec_lo)) * f)


def inv_level_1d_mxu(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, scheme: str,
                     out_dtype=F32) -> torch.Tensor:
    """Polyphase synthesis: a float32 low band and a float32 or bf16 high
    band, each (B, M) -> (B, 2M) in ``out_dtype``."""
    if on_cpu(lo, hi, ndim=2, dtypes=_DT):
        return inv_level_1d_mxu_ref(lo, hi, rec_lo, rec_hi, scheme, out_dtype)
    return _inv_launch("inv_level_1d_mxu", lo, hi, (rec_lo, rec_hi), scheme, out_dtype,
                       2 * lo.shape[-1], 1, 0)


def swt_inv_level_1d_mxu(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, level: int,
                         scheme: str, out_dtype=F32) -> torch.Tensor:
    """A-trous synthesis, 2 x (B, N) -> (B, N), the one 1/2 of a 1D
    synthesis folded into the taps before they are rounded."""
    if on_cpu(lo, hi, ndim=2, dtypes=_DT):
        return swt_inv_level_1d_mxu_ref(lo, hi, rec_lo, rec_hi, level, scheme, out_dtype)
    f = dilation(level)
    return _inv_launch("swt_inv_level_1d_mxu", lo, hi, (_half(rec_lo), _half(rec_hi)),
                       scheme, out_dtype, lo.shape[-1], f,
                       conv.swt_inv_center(len(rec_lo)) * f)


# ---------------------------------------------------------------------------
# autograd: each backward is the paired wrapper with reversed (rescaled) taps
# ---------------------------------------------------------------------------

class _FwdLevel1DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, mode):
        ctx.filters = (dec_lo, dec_hi)
        ctx.back = inv_plan(mode, x.dtype)
        return fwd_level_1d_mxu(x, dec_lo, dec_hi, mode_scheme(mode, x.dtype),
                                mode_out_dtypes(mode)[1])

    @staticmethod
    def backward(ctx, glo, ghi):
        lo, hi = ctx.filters
        y = inv_level_1d_mxu(glo.float().contiguous(), ghi.contiguous(), rev(lo), rev(hi),
                             *ctx.back)
        return y, None, None, None


class _InvLevel1DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lo, hi, rec_lo, rec_hi, mode, out_dtype):
        scheme, out_dtype = inv_plan(mode, out_dtype)
        ctx.filters = (rec_lo, rec_hi)
        ctx.back = (mode_scheme(mode, out_dtype), mode_out_dtypes(mode)[1])
        ctx.in_dtypes = (lo.dtype, hi.dtype)
        if mode == "mixed":
            hi = hi.float()
        return inv_level_1d_mxu(lo.float(), hi, rec_lo, rec_hi, scheme, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        lo, hi = ctx.filters
        res = fwd_level_1d_mxu(gy.contiguous(), rev(lo), rev(hi), *ctx.back)
        return (*(t.to(dt) for t, dt in zip(res, ctx.in_dtypes)), None, None, None, None)


def _swt_inv_plan(mode: str, out_dtype):
    """(scheme, output dtype) of an a-trous synthesis level: ``mixed`` b3
    into float32, ``bf16`` one float32 pass (fd) at every level."""
    if mode == "mixed":
        return "b3", F32
    if mode == "bf16":
        return "fd", BF16 if out_dtype is None else out_dtype
    raise ValueError(f"unknown MXU mode {mode!r}")


class _SwtFwdLevel1DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, level, mode):
        ctx.args = (dec_lo, dec_hi, level)
        ctx.back = _swt_inv_plan(mode, x.dtype)
        return swt_fwd_level_1d_mxu(x, dec_lo, dec_hi, level, swt_scheme(mode, x.dtype),
                                    mode_out_dtypes(mode)[1])

    @staticmethod
    def backward(ctx, glo, ghi):
        lo, hi, level = ctx.args
        y = swt_inv_level_1d_mxu(glo.float().contiguous(), ghi.contiguous(), 2.0 * rev(lo),
                                 2.0 * rev(hi), level, *ctx.back)
        return y, None, None, None, None


class _SwtInvLevel1DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lo, hi, rec_lo, rec_hi, level, mode, out_dtype):
        scheme, out_dtype = _swt_inv_plan(mode, out_dtype)
        ctx.args = (rec_lo, rec_hi, level)
        ctx.back = (swt_scheme(mode, out_dtype), mode_out_dtypes(mode)[1])
        ctx.in_dtypes = (lo.dtype, hi.dtype)
        if mode == "mixed":
            hi = hi.float()
        return swt_inv_level_1d_mxu(lo.float(), hi, rec_lo, rec_hi, level, scheme, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        lo, hi, level = ctx.args
        res = swt_fwd_level_1d_mxu(gy.contiguous(), 0.5 * rev(lo), 0.5 * rev(hi), level,
                                   *ctx.back)
        return (*(t.to(dt) for t, dt in zip(res, ctx.in_dtypes)), None, None, None, None,
                None)


def fwd_level_1d_mxu_ad(x, dec_lo, dec_hi, mode: str):
    """Differentiable decimated analysis in an MXU ``mode``."""
    return _FwdLevel1DMxu.apply(x, dec_lo, dec_hi, mode)


def inv_level_1d_mxu_ad(lo, hi, rec_lo, rec_hi, mode: str, out_dtype=None):
    """Differentiable polyphase synthesis in an MXU ``mode``."""
    return _InvLevel1DMxu.apply(lo, hi, rec_lo, rec_hi, mode, out_dtype)


def swt_fwd_level_1d_mxu_ad(x, dec_lo, dec_hi, level: int, mode: str):
    """Differentiable a-trous analysis in an MXU ``mode``."""
    return _SwtFwdLevel1DMxu.apply(x, dec_lo, dec_hi, level, mode)


def swt_inv_level_1d_mxu_ad(lo, hi, rec_lo, rec_hi, level: int, mode: str, out_dtype=None):
    """Differentiable a-trous synthesis in an MXU ``mode``."""
    return _SwtInvLevel1DMxu.apply(lo, hi, rec_lo, rec_hi, level, mode, out_dtype)
