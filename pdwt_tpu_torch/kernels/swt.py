"""Stationary (a-trous) 2D level kernels: wrappers, plain versions, gradients.

Counterpart of the 2D part of ``pdwt_tpu/kernels/swt_pallas.py``.  Two
CUDA kernels carry the TI-denoise path: kernels 13's and 14's functions
in the ``fd`` scheme on float32 data, so on CUDA tensors they are the
launches of ``kernels/swt_matmul.py``'s launchers (``_fwd_launch``,
``_inv_launch`` and the padded two) in ``fd``, counted under their own
``LAUNCHES`` keys: the bodies of ``csrc/swt_matmul.cu``
(``swt_fwd_mxu_kernel`` at output step 1, ``swt_inv_mxu_kernel``), with
the geometry of ``swt_matmul.swt_fwd_launch_plan`` and
``swt_inv_launch_plan``:

====================  ===============================================  ===========================
wrapper               computes                                         plain version
====================  ===============================================  ===========================
``swt_fwd_level_2d``  one a-trous analysis level, both passes fused    ``swt_fwd_level_2d_ref``
``swt_inv_level_2d``  one a-trous synthesis level, optionally with a   ``swt_inv_level_2d_ref``
                      soft/hard/garrote threshold of H, V, D fused
====================  ===============================================  ===========================

The forward also takes the TI step's thresholded L1 norm as it stores
(``swt_fwd_level_2d(..., norm=(mode, beta, partials, approx))``: kernel
5's norm launches, ``swt_fwd_mxu_kernel<FD, 1, mode>``), one float32
partial a block (``swt_norm_slots``), which ``swt_norm_sum_2d`` adds in
float64 into the norm (``core/separable.py: _swt2d_denoise_norm1``;
``csrc/swt.cu``).

and two padded wrappers for the sharded SWT (``parallel/sharded.py``),
the counterparts of ``swt_pallas.py:935 swt_fwd_level_2d_padded`` and
``:960 swt_inv_level_2d_padded``:

===========================  ==========================================  ==================================
wrapper                      computes                                    plain version
===========================  ==========================================  ==================================
``swt_fwd_level_2d_padded``  kernel 5 on a shard that holds its halo     ``swt_fwd_level_2d_padded_ref``
``swt_inv_level_2d_padded``  kernel 6 on subbands that hold their halo,  ``swt_inv_level_2d_padded_ref``
                             no threshold
===========================  ==========================================  ==================================

They run the same bodies (``swt_matmul.cu: swt_fwd_padded_kernel`` on
``fwd_tile<FD, 1, true>``, ``swt_inv_mxu_kernel<FD, true>``) with index
tables that do not wrap, on the spec of ``conv.padded_atrous_analysis_pass``
and ``conv.padded_atrous_synthesis_pass``: a valid correlation at dilation
f over the halo the caller exchanged, ``_launch.swt_fwd_halo`` /
``swt_inv_halo`` per axis, and the C entry refuses a plan whose outputs
would read outside it.  As JAX's padded functions, they have no gradient:
the ring exchange around them is not differentiable.

Level L dilates the taps by ``f = 2^(L-1)``; every output is full size.  A
wrapper given a CPU tensor returns its plain version, built on
``core/conv.py``; given a CUDA tensor it launches its kernel or raises.
Each launch adds one to ``LAUNCHES[<wrapper name>]``.  The forward kernel
runs its passes in kernel 13's order, rows first (as the Pallas kernel,
``swt_pallas.py:129-133``), its plain version the columns first: the two
agree to float32 roundoff.

Filters are forward-convention float64 arrays.  As in the JAX wrapper
(``swt_pallas.py:369``), the synthesis's 1/2 per pass is folded into the
inverse's taps here, not in the kernel.

Gradients: the a-trous analysis with filters g at center
``fwd_center(hlen) * f`` has as adjoint the synthesis with filters g[::-1]
at ``(hlen - 1 - fwd_center(hlen)) * f``, and that equals
``swt_inv_center(hlen) * f`` for odd as for even ``hlen``.  The inverse
kernel scales its taps by 1/2, so the forward's backward is the inverse
kernel with ``2 * g[::-1]``, and the inverse's backward the forward kernel
with ``0.5 * g[::-1]`` (``swt_pallas.py:703-737``).  The fused denoise's
backward runs the forward kernel on the cotangent and chains it through
the threshold's a.e. derivative, masked by the un-thresholded details
(``swt_pallas.py:767-786``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import conv
from ..utils.profiling import spanned
from ._launch import THRESH_CODES, _c, dilation, launch, on_cpu, ptr, rev
from .matmul import F32
from .swt_matmul import (Norm, Threshold, _fwd_launch, _fwd_padded_launch, _inv_launch,
                         _inv_padded_launch, swt_fwd_launch_plan, thresh_vjp)


# ---------------------------------------------------------------------------
# plain versions (core/conv.py), any device, float32 or float64
# ---------------------------------------------------------------------------

def swt_fwd_level_2d_ref(x: torch.Tensor, dec_lo, dec_hi, level: int):
    """One a-trous analysis level on (B, R, C): columns, then rows."""
    f = dilation(level)
    dec = (dec_lo, dec_hi)
    z = conv.analysis_pass(x[:, None], dec, axis=-1, dilation=f, decimate=False)
    z = conv.analysis_pass(z, dec, axis=-2, dilation=f, decimate=False)
    return tuple(z[:, k].contiguous() for k in range(4))


def swt_inv_level_2d_ref(a, h, v, d, rec_lo, rec_hi, level: int,
                         threshold: Threshold = None) -> torch.Tensor:
    """One a-trous synthesis level, rows then columns, 1/2 per pass;
    ``threshold=(mode, beta)`` first thresholds H, V and D."""
    f = dilation(level)
    if threshold is not None:
        from ..ops.threshold import THR_ELEM

        mode, beta = threshold
        h, v, d = (THR_ELEM[mode](t, beta) for t in (h, v, d))
    rec = (0.5 * np.asarray(rec_lo, np.float64), 0.5 * np.asarray(rec_hi, np.float64))
    z = torch.stack([a, h, v, d], dim=1)
    t = conv.synthesis_pass(z, rec, axis=-2, dilation=f, decimated=False)
    return conv.synthesis_pass(t, rec, axis=-1, dilation=f, decimated=False)[:, 0].contiguous()


def swt_norm_partials_ref(bands, mode: str, beta, partials: torch.Tensor, approx: bool) -> None:
    """The plain version of a norm launch's partials: the thresholded L1
    norm of H, V and D (``ops.norms.thresholded_l1``, float32 sums), plus
    sum |A| where ``approx``, in ``partials[0]``, zeros after."""
    from ..ops.norms import thresholded_l1

    a, h, v, d = bands
    total = sum(thresholded_l1(t, beta, mode) for t in (h, v, d))
    if approx:
        total = total + a.abs().sum()
    partials.zero_()
    partials[0] = total


def swt_fwd_level_2d_padded_ref(xp: torch.Tensor, dec_lo, dec_hi, level: int):
    """One a-trous analysis level on a (B, Rp, Cp) shard that holds its
    halo: ``out[n] = sum_j frev[j] xp[n + j f]`` along the columns, then
    the rows, no wrap -> four (B, Rp - (hlen - 1) f, Cp - (hlen - 1) f)
    planes."""
    f, dec = dilation(level), (dec_lo, dec_hi)
    z = conv.padded_atrous_analysis_pass(xp[:, None], dec, -1, f)
    z = conv.padded_atrous_analysis_pass(z, dec, -2, f)
    return tuple(z[:, k].contiguous() for k in range(4))


def swt_inv_level_2d_padded_ref(a, h, v, d, rec_lo, rec_hi, level: int) -> torch.Tensor:
    """One a-trous synthesis level on (B, Rp, Cp) subbands that hold their
    halo, rows then columns, 1/2 per pass, no wrap -> (B, Rp - (hlen - 1)
    f, Cp - (hlen - 1) f)."""
    f = dilation(level)
    rec = (0.5 * np.asarray(rec_lo, np.float64), 0.5 * np.asarray(rec_hi, np.float64))
    t = conv.padded_atrous_synthesis_pass(torch.stack([a, h, v, d], dim=1), rec, -2, f)
    return conv.padded_atrous_synthesis_pass(t, rec, -1, f)[:, 0].contiguous()


def swt_norm_slots(B: int, R: int, C: int, hlen: int, level: int) -> int:
    """The partials a norm launch of kernel 5 writes on a (B, R, C) image:
    one a block of its plan."""
    return math.prod(swt_fwd_launch_plan(B, R, C, hlen, dilation(level), "fd").grid)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@spanned("kernels")
def swt_fwd_level_2d(x: torch.Tensor, dec_lo, dec_hi, level: int, *, norm: Norm = None):
    """One a-trous analysis level: (B, R, C) -> (a, h, v, d), each (B, R, C).
    Any size, including one smaller than the dilated support.
    ``norm=(mode, beta, partials, approx)`` also writes the thresholded L1
    norm of H, V and D (mode soft, hard or garrote; beta a number or a
    one-element tensor), plus sum |A| where ``approx``, into ``partials``:
    ``swt_norm_slots`` float32s, one a block, for ``swt_norm_sum_2d``."""
    if norm is not None and norm[0] not in ("soft", "hard", "garrote"):
        raise ValueError(f"norm mode {norm[0]!r}: the kernel takes soft, hard or garrote")
    if on_cpu(x):
        bands = swt_fwd_level_2d_ref(x, dec_lo, dec_hi, level)
        if norm is not None:
            swt_norm_partials_ref(bands, *norm)
        return bands
    return _fwd_launch("swt_fwd_level_2d", x, (dec_lo, dec_hi), level, "fd", F32, norm)


@spanned("kernels")
def swt_norm_sum_2d(partials: torch.Tensor) -> torch.Tensor:
    """The sum of kernel 5's norm partials (a 1-D float32 tensor), taken in
    float64 in a fixed order: a 0-dim float32 tensor, the same bits every
    call."""
    if on_cpu(partials, ndim=1):
        return partials.sum(dtype=torch.float64).to(torch.float32)
    out = torch.empty((), dtype=torch.float32, device=partials.device)
    launch("swt_norm_sum_2d", partials.device, [ptr(partials), partials.numel(), ptr(out)])
    return out


@spanned("kernels")
def swt_inv_level_2d(a, h, v, d, rec_lo, rec_hi, level: int,
                     threshold: Threshold = None) -> torch.Tensor:
    """One a-trous synthesis level: four (B, R, C) subbands -> (B, R, C).
    ``threshold=(mode, beta)``, mode in soft/hard/garrote, thresholds H, V
    and D as they are read; beta is a number or a one-element tensor.  Not
    differentiable: see :func:`swt_inv_level_2d_denoise_ad`."""
    mode, beta = (None, None) if threshold is None else threshold
    if mode not in THRESH_CODES:
        raise ValueError(f"threshold mode {mode!r}: the kernel takes soft, hard or garrote")
    if on_cpu(a, h, v, d):
        return swt_inv_level_2d_ref(a, h, v, d, rec_lo, rec_hi, level, threshold)
    return _inv_launch("swt_inv_level_2d", a, h, v, d, (rec_lo, rec_hi), level, "fd", F32,
                       threshold)


@spanned("kernels")
def swt_fwd_level_2d_padded(xp: torch.Tensor, dec_lo, dec_hi, level: int):
    """One a-trous analysis level on a (B, Rp, Cp) float32 shard that holds
    its halo -> (a, h, v, d), each (B, Rp - (hlen - 1) f, Cp - (hlen - 1)
    f): on a CUDA tensor, kernel 13's padded launch in fd
    (``swt_matmul.swt_fwd_padded_launch_plan``)."""
    if on_cpu(xp):
        return swt_fwd_level_2d_padded_ref(xp, dec_lo, dec_hi, level)
    return _fwd_padded_launch("swt_fwd_level_2d_padded", xp, (dec_lo, dec_hi), level, "fd", F32)


@spanned("kernels")
def swt_inv_level_2d_padded(a, h, v, d, rec_lo, rec_hi, level: int) -> torch.Tensor:
    """One a-trous synthesis level on four (B, Rp, Cp) float32 subbands
    that hold their halo -> (B, Rp - (hlen - 1) f, Cp - (hlen - 1) f), the
    1/2 per pass folded into the taps: on CUDA tensors, kernel 14's padded
    launch in fd (``swt_matmul.swt_inv_padded_launch_plan``)."""
    if on_cpu(a, h, v, d):
        return swt_inv_level_2d_padded_ref(a, h, v, d, rec_lo, rec_hi, level)
    return _inv_padded_launch("swt_inv_level_2d_padded", a, h, v, d, (rec_lo, rec_hi), level,
                              "fd", F32)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _SwtFwdLevel2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, level):
        ctx.args = (dec_lo, dec_hi, level)
        return swt_fwd_level_2d(x, dec_lo, dec_hi, level)

    @staticmethod
    def backward(ctx, ga, gh, gv, gd):
        lo, hi, level = ctx.args
        y = swt_inv_level_2d(*_c((ga, gh, gv, gd)), 2.0 * rev(lo), 2.0 * rev(hi), level)
        return y, None, None, None


class _SwtInvLevel2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, rec_lo, rec_hi, level):
        ctx.args = (rec_lo, rec_hi, level)
        return swt_inv_level_2d(a, h, v, d, rec_lo, rec_hi, level)

    @staticmethod
    def backward(ctx, gy):
        lo, hi, level = ctx.args
        return (*swt_fwd_level_2d(gy.contiguous(), 0.5 * rev(lo), 0.5 * rev(hi), level),
                None, None, None)


class _SwtInvLevel2DDenoise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, beta, rec_lo, rec_hi, level, mode):
        ctx.args = (rec_lo, rec_hi, level, mode)
        ctx.beta_is_tensor = isinstance(beta, torch.Tensor)
        ctx.beta = None if ctx.beta_is_tensor else beta
        ctx.save_for_backward(h, v, d, *([beta] if ctx.beta_is_tensor else []))
        return swt_inv_level_2d(a, h, v, d, rec_lo, rec_hi, level, threshold=(mode, beta))

    @staticmethod
    def backward(ctx, gy):
        lo, hi, level, mode = ctx.args
        h, v, d, *rest = ctx.saved_tensors
        beta = rest[0] if ctx.beta_is_tensor else ctx.beta
        ga, *gbands = swt_fwd_level_2d(gy.contiguous(), 0.5 * rev(lo), 0.5 * rev(hi), level)
        b = (beta.detach().to(h.dtype) if ctx.beta_is_tensor
             else torch.tensor(beta, dtype=h.dtype))
        outs, gbeta = thresh_vjp(mode, (h, v, d), gbands, b, beta)
        return (ga, *outs, gbeta, None, None, None, None)


def swt_fwd_level_2d_ad(x, dec_lo, dec_hi, level: int):
    """Differentiable :func:`swt_fwd_level_2d`."""
    return _SwtFwdLevel2D.apply(x, dec_lo, dec_hi, level)


def swt_inv_level_2d_ad(a, h, v, d, rec_lo, rec_hi, level: int):
    """Differentiable :func:`swt_inv_level_2d` without a threshold."""
    return _SwtInvLevel2D.apply(a, h, v, d, rec_lo, rec_hi, level)


def swt_inv_level_2d_denoise_ad(a, h, v, d, beta, rec_lo, rec_hi, level: int,
                                mode: str):
    """Differentiable fused threshold + synthesis level: the same values as
    ``swt_inv_level_2d(..., threshold=(mode, beta))``, with gradients for
    the four subbands and, when ``beta`` is a tensor, for beta."""
    return _SwtInvLevel2DDenoise.apply(a, h, v, d, beta, rec_lo, rec_hi, level, mode)
