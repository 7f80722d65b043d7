"""Batched 1D level kernels: wrappers, plain versions, gradients.

Counterpart of the batched 1D part of ``pdwt_tpu/kernels/swt_pallas.py``.
Four CUDA kernels carry the batched 1D path, each filtering along the
last axis of a (B, N) batch of signals:

===========================  ===========================================  ===============================
wrapper                      computes                                     plain version
===========================  ===========================================  ===============================
``fwd_level_1d``             one decimated analysis level                 ``fwd_level_1d_ref``
``fwd_level_1d_norm``        kernel 7, the high band thresholded and its  ``fwd_level_1d_ref``, the
                             L1 norm summed as it is stored               threshold and norm ops
``inv_level_1d``             one polyphase synthesis level                ``inv_level_1d_ref``
``swt_fwd_level_1d``         one a-trous analysis level                   ``swt_fwd_level_1d_ref``
``swt_inv_level_1d``         one a-trous synthesis level                  ``swt_inv_level_1d_ref``
``fwd_level_1d_padded``      kernel 7 on signals holding their extension  ``fwd_level_1d_padded_ref``
``inv_level_1d_padded``      kernel 8 on padded bands, no wrap            ``inv_level_1d_padded_ref``
``swt_fwd_level_1d_padded``  kernel 9 on shards holding their halo        ``swt_fwd_level_1d_padded_ref``
``swt_inv_level_1d_padded``  kernel 10 on bands holding their halo        ``swt_inv_level_1d_padded_ref``
===========================  ===========================================  ===============================

A wrapper given a CPU tensor returns its plain version, built on
``core/conv.py``; given a CUDA tensor it launches its kernel or raises.
Each launch adds one to ``LAUNCHES[<wrapper name>]``.  The kernels take
any batch, length, filter length (odd included) and dilation.  All four
are kernels 15's and 16's functions in the ``fd`` scheme on float32 data,
so on CUDA tensors they are the launches of ``kernels/mxu1d.py``'s
launchers in ``fd`` (the bodies of ``csrc/mxu1d.cu``: the decimated or
a-trous analysis, the polyphase or a-trous synthesis, on the plans of
``mxu1d.fwd1d_launch_plan`` and ``mxu1d.inv1d_launch_plan``), counted
under their own ``LAUNCHES`` keys.

Kernel 7 also thresholds the batched 1D denoising step's details as it
stores them and takes their L1 norm (``fwd_level_1d_norm(..., norm=(mode,
beta))``: its norm launches, ``csrc/mxu1d.cu: pdwt_fwd_level_1d_norm``
onto ``fwd1d_strip_kernel<FD, 2, false, mode>``),
one float32 partial a block of its plan, which ``swt_norm_sum_2d`` adds
(``core/separable.py: _dwt1d_denoise_norm1``).

The padded wrappers, the counterparts of ``swt_pallas.py:995
fwd_level_1d_padded`` and ``:1018 inv_level_1d_padded``, carry the boundary
modes (``core/separable.py``'s mode route): the decimated and polyphase
bodies with index tables that do not wrap, on the spec of
``conv.padded_analysis_pass`` and ``conv.padded_synthesis_pass``, as the 2D
pair of ``kernels/separable.py``; their backward is the exact adjoint
through the plain versions.  Those of kernels 9 and 10, the counterparts
of ``swt_pallas.py:1043 swt_fwd_level_1d_padded`` and ``:1069
swt_inv_level_1d_padded``, carry the sharded SWT (``parallel/sharded.py``):
the a-trous bodies with index tables that do not wrap, on the spec of
``conv.padded_atrous_analysis_pass`` and ``padded_atrous_synthesis_pass``
over the halo of ``_launch.swt_fwd_halo`` / ``swt_inv_halo``; as JAX's,
they have no gradient.

Filters are forward-convention float64 arrays.  A 1D a-trous synthesis is
one pass, so the wrapper folds ONE 1/2 into the inverse's taps
(``swt_pallas.py:660``), where the 2D inverse folds one per pass.

Gradients (``swt_pallas.py:792-907``): the decimated analysis's backward is
the synthesis kernel with ``g[::-1]`` and the synthesis's backward the
analysis kernel with ``g[::-1]``; the a-trous analysis's backward is the
a-trous synthesis kernel with ``2 * g[::-1]`` (cancelling its 1/2), and the
a-trous synthesis's backward the a-trous analysis kernel with
``0.5 * g[::-1]``.  The centers pair for odd as for even ``hlen``
(``tests/test_torch_batched1d_kernels.py``).
"""
from __future__ import annotations

import torch

from ..core import conv
from ..utils.profiling import spanned
from ._launch import dilation, on_cpu, rev
from .matmul import F32
from .mxu1d import (Norm1D, _fwd_launch, _fwd_padded_launch, _half, _inv_launch,
                    _inv_padded_launch, _swt_fwd_padded_launch, _swt_inv_padded_launch)
from .separable import meta, plain_vjp


# ---------------------------------------------------------------------------
# plain versions (core/conv.py), any device, float32 or float64
# ---------------------------------------------------------------------------

def fwd_level_1d_ref(x: torch.Tensor, dec_lo, dec_hi):
    """One decimated analysis level, (B, N) -> (lo, hi), each (B, N/2)."""
    z = conv.analysis_pass(x[:, None, None], (dec_lo, dec_hi), axis=-1)
    return z[:, 0, 0].contiguous(), z[:, 1, 0].contiguous()


def inv_level_1d_ref(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi) -> torch.Tensor:
    """One polyphase synthesis level, 2 x (B, M) -> (B, 2M)."""
    z = torch.stack([lo, hi], dim=1)[:, :, None]
    return conv.synthesis_pass(z, (rec_lo, rec_hi), axis=-1)[:, 0, 0].contiguous()


def swt_fwd_level_1d_ref(x: torch.Tensor, dec_lo, dec_hi, level: int):
    """One a-trous analysis level, (B, N) -> (lo, hi), each (B, N)."""
    z = conv.analysis_pass(x[:, None, None], (dec_lo, dec_hi), axis=-1,
                           dilation=dilation(level), decimate=False)
    return z[:, 0, 0].contiguous(), z[:, 1, 0].contiguous()


def swt_inv_level_1d_ref(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi,
                         level: int) -> torch.Tensor:
    """One a-trous synthesis level with one 1/2, 2 x (B, N) -> (B, N)."""
    z = torch.stack([lo, hi], dim=1)[:, :, None]
    return conv.synthesis_pass(z, (_half(rec_lo), _half(rec_hi)), axis=-1,
                               dilation=dilation(level), decimated=False)[:, 0, 0].contiguous()


def fwd_level_1d_padded_ref(xp: torch.Tensor, dec_lo, dec_hi):
    """One decimated analysis level on (B, Np) signals that hold their
    boundary extension, ``out[n] = sum_j frev[j] xp[2n + j]``, no wrap ->
    (lo, hi), each (B, (Np - hlen) // 2 + 1)."""
    z = conv.padded_analysis_pass(xp[:, None, None], (dec_lo, dec_hi), axis=-1)
    return z[:, 0, 0].contiguous(), z[:, 1, 0].contiguous()


def inv_level_1d_padded_ref(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, c0: int,
                            out_len: int) -> torch.Tensor:
    """One polyphase synthesis level on (B, M) bands that hold their
    boundary, no wrap: ``out[i] = sum_k sum_j rev_k[j] U_k[i + c0 + j]``
    for ``i < out_len`` (``conv.padded_synthesis_pass``) -> (B, out_len)."""
    z = torch.stack([lo, hi], dim=1)[:, :, None]
    return conv.padded_synthesis_pass(z, (rec_lo, rec_hi), -1, c0,
                                      out_len)[:, 0, 0].contiguous()


def swt_fwd_level_1d_padded_ref(xp: torch.Tensor, dec_lo, dec_hi, level: int):
    """One a-trous analysis level on (B, Np) signals that hold their halo,
    ``out[n] = sum_j frev[j] xp[n + j f]``, no wrap -> (lo, hi), each (B, Np
    - (hlen - 1) f)."""
    z = conv.padded_atrous_analysis_pass(xp[:, None, None], (dec_lo, dec_hi), -1,
                                         dilation(level))
    return z[:, 0, 0].contiguous(), z[:, 1, 0].contiguous()


def swt_inv_level_1d_padded_ref(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi,
                                level: int) -> torch.Tensor:
    """One a-trous synthesis level with one 1/2 on (B, Mp) bands that hold
    their halo, no wrap -> (B, Mp - (hlen - 1) f)."""
    z = torch.stack([lo, hi], dim=1)[:, :, None]
    return conv.padded_atrous_synthesis_pass(z, (_half(rec_lo), _half(rec_hi)), -1,
                                             dilation(level))[:, 0, 0].contiguous()


# ---------------------------------------------------------------------------
# wrappers: on CUDA tensors, the launchers of kernels 15 and 16
# (kernels/mxu1d.py) in fd
# ---------------------------------------------------------------------------

@spanned("kernels")
def fwd_level_1d(x: torch.Tensor, dec_lo, dec_hi):
    """One decimated analysis level on (B, N), N even -> (lo, hi), each
    (B, N/2)."""
    if on_cpu(x, ndim=2):
        return fwd_level_1d_ref(x, dec_lo, dec_hi)
    return _fwd_launch("fwd_level_1d", x, (dec_lo, dec_hi), "fd", F32, 1,
                       conv.fwd_center(len(dec_lo)), True)


@spanned("kernels")
def fwd_level_1d_norm(x: torch.Tensor, dec_lo, dec_hi, *, norm: Norm1D):
    """Kernel 7's norm launch: :func:`fwd_level_1d` with ``norm=(mode,
    beta)`` (mode soft, hard or garrote; beta a number or a one-element
    tensor) -> (lo, hi thresholded at beta, partials): the float32 partials
    of the thresholded band's L1 norm, one a block of the launch's plan, for
    ``swt_norm_sum_2d``.  The plain version gives one partial, the threshold
    ops' band and ``ops.norms.thresholded_l1``'s float32 sum.  A wrapper of
    its own, as its launch counter is."""
    mode, beta = norm
    if mode not in ("soft", "hard", "garrote"):
        raise ValueError(f"norm mode {mode!r}: the kernel takes soft, hard or garrote")
    if on_cpu(x, ndim=2):
        from ..ops.norms import thresholded_l1
        from ..ops.threshold import THR_ELEM

        lo, hi = fwd_level_1d_ref(x, dec_lo, dec_hi)
        return lo, THR_ELEM[mode](hi, beta), thresholded_l1(hi, beta, mode).reshape(1)
    return _fwd_launch("fwd_level_1d_norm", x, (dec_lo, dec_hi), "fd", F32, 1,
                       conv.fwd_center(len(dec_lo)), True, norm)


@spanned("kernels")
def inv_level_1d(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi) -> torch.Tensor:
    """One polyphase synthesis level: 2 x (B, M) -> (B, 2M)."""
    if on_cpu(lo, hi, ndim=2):
        return inv_level_1d_ref(lo, hi, rec_lo, rec_hi)
    return _inv_launch("inv_level_1d", lo, hi, (rec_lo, rec_hi), "fd", F32, 1, 0, True)


@spanned("kernels")
def swt_fwd_level_1d(x: torch.Tensor, dec_lo, dec_hi, level: int):
    """One a-trous analysis level: (B, N) -> (lo, hi), each (B, N).  Any
    length, including one shorter than the dilated support."""
    if on_cpu(x, ndim=2):
        return swt_fwd_level_1d_ref(x, dec_lo, dec_hi, level)
    f = dilation(level)
    return _fwd_launch("swt_fwd_level_1d", x, (dec_lo, dec_hi), "fd", F32, f,
                       conv.fwd_center(len(dec_lo)) * f, False)


@spanned("kernels")
def swt_inv_level_1d(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi,
                     level: int) -> torch.Tensor:
    """One a-trous synthesis level: 2 x (B, N) -> (B, N), the one 1/2 of a
    1D synthesis folded into the taps."""
    if on_cpu(lo, hi, ndim=2):
        return swt_inv_level_1d_ref(lo, hi, rec_lo, rec_hi, level)
    f = dilation(level)
    return _inv_launch("swt_inv_level_1d", lo, hi, (_half(rec_lo), _half(rec_hi)), "fd", F32,
                       f, conv.swt_inv_center(len(rec_lo)) * f, False)


@spanned("kernels")
def fwd_level_1d_padded(xp: torch.Tensor, dec_lo, dec_hi):
    """One decimated analysis level on (B, Np) float32 signals that hold
    their boundary extension -> (lo, hi), each (B, (Np - hlen) // 2 + 1),
    on ``mxu1d.fwd1d_padded_launch_plan``."""
    if on_cpu(xp, ndim=2):
        return fwd_level_1d_padded_ref(xp, dec_lo, dec_hi)
    return _fwd_padded_launch("fwd_level_1d_padded", xp, (dec_lo, dec_hi), "fd", F32)


@spanned("kernels")
def inv_level_1d_padded(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, c0: int,
                        out_len: int) -> torch.Tensor:
    """One polyphase synthesis level on (B, M) float32 bands that hold their
    boundary -> (B, out_len), the spec of ``inv_level_1d_padded_ref``, on
    ``mxu1d.inv1d_padded_launch_plan``.  Raises where an output would read
    outside the bands."""
    if on_cpu(lo, hi, ndim=2):
        return inv_level_1d_padded_ref(lo, hi, rec_lo, rec_hi, c0, out_len)
    return _inv_padded_launch("inv_level_1d_padded", lo, hi, (rec_lo, rec_hi), "fd", c0,
                              out_len, F32)


@spanned("kernels")
def swt_fwd_level_1d_padded(xp: torch.Tensor, dec_lo, dec_hi, level: int):
    """One a-trous analysis level on (B, Np) float32 signals that hold their
    halo -> (lo, hi), each (B, Np - (hlen - 1) f), on
    ``mxu1d.swt_fwd1d_padded_launch_plan``."""
    if on_cpu(xp, ndim=2):
        return swt_fwd_level_1d_padded_ref(xp, dec_lo, dec_hi, level)
    return _swt_fwd_padded_launch("swt_fwd_level_1d_padded", xp, (dec_lo, dec_hi), level, "fd",
                                  F32)


@spanned("kernels")
def swt_inv_level_1d_padded(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi,
                            level: int) -> torch.Tensor:
    """One a-trous synthesis level on two (B, Mp) float32 bands that hold
    their halo -> (B, Mp - (hlen - 1) f), the one 1/2 of a 1D synthesis
    folded into the taps, on ``mxu1d.swt_inv1d_padded_launch_plan``."""
    if on_cpu(lo, hi, ndim=2):
        return swt_inv_level_1d_padded_ref(lo, hi, rec_lo, rec_hi, level)
    return _swt_inv_padded_launch("swt_inv_level_1d_padded", lo, hi, (rec_lo, rec_hi), level,
                                  "fd", F32)


# ---------------------------------------------------------------------------
# autograd: each backward is the paired kernel with reversed (rescaled)
# taps; the padded entry points' the exact adjoint through their plain
# versions
# ---------------------------------------------------------------------------

class _FwdLevel1D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi):
        ctx.filters = (dec_lo, dec_hi)
        return fwd_level_1d(x, dec_lo, dec_hi)

    @staticmethod
    def backward(ctx, glo, ghi):
        lo, hi = ctx.filters
        return inv_level_1d(glo.contiguous(), ghi.contiguous(), rev(lo), rev(hi)), None, None


class _InvLevel1D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lo, hi, rec_lo, rec_hi):
        ctx.filters = (rec_lo, rec_hi)
        return inv_level_1d(lo, hi, rec_lo, rec_hi)

    @staticmethod
    def backward(ctx, gy):
        lo, hi = ctx.filters
        return (*fwd_level_1d(gy.contiguous(), rev(lo), rev(hi)), None, None)


class _SwtFwdLevel1D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, level):
        ctx.args = (dec_lo, dec_hi, level)
        return swt_fwd_level_1d(x, dec_lo, dec_hi, level)

    @staticmethod
    def backward(ctx, glo, ghi):
        lo, hi, level = ctx.args
        y = swt_inv_level_1d(glo.contiguous(), ghi.contiguous(), 2.0 * rev(lo),
                             2.0 * rev(hi), level)
        return y, None, None, None


class _SwtInvLevel1D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lo, hi, rec_lo, rec_hi, level):
        ctx.args = (rec_lo, rec_hi, level)
        return swt_inv_level_1d(lo, hi, rec_lo, rec_hi, level)

    @staticmethod
    def backward(ctx, gy):
        lo, hi, level = ctx.args
        return (*swt_fwd_level_1d(gy.contiguous(), 0.5 * rev(lo), 0.5 * rev(hi), level),
                None, None, None)


class _FwdLevel1DPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, dec_lo, dec_hi):
        ctx.filters, ctx.like = (dec_lo, dec_hi), meta(xp)
        return fwd_level_1d_padded(xp, dec_lo, dec_hi)

    @staticmethod
    def backward(ctx, glo, ghi):
        lo, hi = ctx.filters
        (gx,) = plain_vjp(lambda t: fwd_level_1d_padded_ref(t, lo, hi), ctx.like, (glo, ghi))
        return gx, None, None


class _InvLevel1DPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lo, hi, rec_lo, rec_hi, c0, out_len):
        ctx.args = (rec_lo, rec_hi, c0, out_len)
        ctx.like = ((2,) + tuple(lo.shape), lo.dtype, lo.device)
        return inv_level_1d_padded(lo, hi, rec_lo, rec_hi, c0, out_len)

    @staticmethod
    def backward(ctx, gy):
        rlo, rhi, c0, n = ctx.args
        ref = lambda z: inv_level_1d_padded_ref(z[0], z[1], rlo, rhi, c0, n)
        (g,) = plain_vjp(ref, ctx.like, gy.contiguous())
        return g[0], g[1], None, None, None, None


def fwd_level_1d_ad(x, dec_lo, dec_hi):
    """Differentiable :func:`fwd_level_1d`."""
    return _FwdLevel1D.apply(x, dec_lo, dec_hi)


def inv_level_1d_ad(lo, hi, rec_lo, rec_hi):
    """Differentiable :func:`inv_level_1d`."""
    return _InvLevel1D.apply(lo, hi, rec_lo, rec_hi)


def swt_fwd_level_1d_ad(x, dec_lo, dec_hi, level: int):
    """Differentiable :func:`swt_fwd_level_1d`."""
    return _SwtFwdLevel1D.apply(x, dec_lo, dec_hi, level)


def swt_inv_level_1d_ad(lo, hi, rec_lo, rec_hi, level: int):
    """Differentiable :func:`swt_inv_level_1d`."""
    return _SwtInvLevel1D.apply(lo, hi, rec_lo, rec_hi, level)


def fwd_level_1d_padded_ad(xp, dec_lo, dec_hi):
    """Differentiable :func:`fwd_level_1d_padded`."""
    return _FwdLevel1DPadded.apply(xp, dec_lo, dec_hi)


def inv_level_1d_padded_ad(lo, hi, rec_lo, rec_hi, c0: int, out_len: int):
    """Differentiable :func:`inv_level_1d_padded`."""
    return _InvLevel1DPadded.apply(lo, hi, rec_lo, rec_hi, c0, out_len)
