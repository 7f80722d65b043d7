"""Banded-product level kernels of the precision tiers, 2D a-trous: the
route rule, wrappers, plain versions and gradients.

Counterpart of ``pdwt_tpu/kernels/swt_matmul_pallas.py`` (kernels 13 and
14), which carry the TI-denoise step under the bf16 tiers.  A dilated dual
FIR is still a banded matrix product, its band with stride
``f = 2^(level-1)``; the CUDA kernels (``csrc/swt_matmul.cu``) and the plain
versions here compute it under a compute scheme of ``kernels/matmul.py``
(its docstring states each scheme's arithmetic):

=================================  ==========================================  ===========
wrapper                            computes                                    plain
=================================  ==========================================  ===========
``swt_fwd_level_2d_mxu``           one a-trous analysis level, rows then cols  ``*_ref``
``swt_inv_level_2d_mxu``           one a-trous synthesis level, rows then      ``*_ref``
                                   cols, with an optional soft/hard/garrote
                                   threshold of H, V, D fused
``swt_fwd_level_2d_mxu_padded``    13 on a shard holding its halo, no wrap     ``*_ref``
``swt_inv_level_2d_mxu_padded``    14 on subbands holding their halo, no       ``*_ref``
                                   wrap, no threshold
=================================  ==========================================  ===========

The padded entry points are the counterparts of the ``pad_fn=`` of
``swt_matmul_pallas.py:252 swt_fwd_level_2d_mxu`` and ``:402
swt_inv_level_2d_mxu``, which JAX's sharded SWT passes its ring halo
exchange: the same bodies with index tables that do not wrap, on a shard
wrapped by its bare periodic support (``kernels.swt_fwd_halo`` /
``swt_inv_halo``), on the spec of ``conv.padded_atrous_analysis_pass``
and ``conv.padded_atrous_synthesis_pass``.

Each body and geometry has one launcher here (``_fwd_launch``,
``_inv_launch``, ``_fwd_padded_launch``, ``_inv_padded_launch``), which
takes the scheme and the ``LAUNCHES`` key: the wrappers below call them in
their scheme, the exact wrappers of kernels 5 and 6 and their padded forms
(``kernels/swt.py``) in ``fd`` on float32, kernel 5's norm launches
included.

The synthesis folds its 1/2 per pass into the taps before they are
rounded (``swt_matmul_pallas.py:93-108``).  The fused threshold is the TPU
kernel's (``swt_pallas.py:206-214``), applied in float32 to each detail
before its scheme split; ``fused_threshold`` computes it as that kernel
does (garrote divides a tensor by a tensor).  A wrapper given a CPU tensor
returns its plain version; given a CUDA tensor it launches its kernel or
raises.

Gradients (``swt_matmul_pallas.py:459-570``): the forward's backward is
the inverse kernel with ``2 * g[::-1]``, the inverse's the forward kernel
with ``0.5 * g[::-1]``, each in the same mode and into the input's dtype;
the fused denoise's backward runs the forward kernel on the cotangent and
chains it through the threshold's a.e. derivative, masked by the
un-thresholded details.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..core import conv
from ..utils.profiling import spanned
from ._launch import (COL_STRIP, PLAN_TILES, ROW_STRIP, THRESH_CODES, InvPlan, _c, align16,
                      axis_blocks, beta_buffer, block_target, cdiv, check_span,
                      consecutive_columns, dilation, fwd_plan, launch, on_cpu, pick_plan,
                      plan_threads, ptr, rev, stage_bytes, temp_pitch)
from .matmul import (_DT, BF16, F32, MXU_MAX_HLEN, SCHEMES, _check_approx, _check_bands,
                     _check_scheme, _is_bf16, dual_taps, fwd2d_ref, inv2d_ref, mode_out_dtypes,
                     swt_bf16_scheme, swt_scheme, tile_candidates)
from .mxu1d import _half

#: (mode, beta) of a fused threshold
Threshold = Optional[Tuple[str, object]]
#: (mode, beta, partials, approx) of a norm launch of kernel 5
Norm = Optional[Tuple[str, object, torch.Tensor, bool]]


def mxu_route_swt_2d(r: int, c: int, hlen: int, level: int) -> bool:
    """Does an a-trous 2D level on (r, c) images take the banded-product
    kernels?  The gate of ``_swt_mxu_tiles`` (``swt_matmul_pallas.py:53-74``):
    an even filter of at most 40 taps and some TPU tile (TR, TC) that
    divides (r, c) with the dilated span ``(hlen-1) * 2^(level-1)`` at most
    2 TR.  The TPU gate tries the tiles in a scheme's order and takes the
    first that fits, so the scheme cannot change the answer; its VMEM
    estimate never binds for 40 taps or fewer (both tested against JAX)."""
    if hlen % 2 or hlen > MXU_MAX_HLEN:
        return False
    span = (hlen - 1) * dilation(level)
    return any(r % tr == 0 and c % tc == 0 and span <= 2 * tr
               for tr, tc in tile_candidates("b1"))


def swt2d_inv_plan(mode: str, out_dtype: Optional[torch.dtype]):
    """(scheme, output dtype) of an a-trous synthesis level
    (``swt_matmul_pallas.py:410-421``): ``mixed`` b3 into float32; ``bf16``
    fd, or b2f under the balanced and accurate rungs, into bf16 unless
    ``out_dtype`` says otherwise."""
    if mode == "mixed":
        return "b3", F32
    if mode == "bf16":
        return swt_bf16_scheme("fd"), BF16 if out_dtype is None else out_dtype
    raise ValueError(f"unknown MXU mode {mode!r}")


def fused_threshold(x: torch.Tensor, mode: str, beta) -> torch.Tensor:
    """The fused threshold of the TPU kernels (``swt_pallas.py:206-214``)
    on a float32 tensor, with beta rounded to float32."""
    b = beta_buffer(beta, x.device).reshape(())
    if mode == "soft":
        return torch.sign(x) * torch.clamp(x.abs() - b, min=0.0)
    if mode == "hard":
        return torch.where(x.abs() > b, x, 0.0)
    if mode == "garrote":
        safe = torch.where(x == 0, 1.0, x)
        return torch.where(x * x > b * b, x - torch.div((b * b).expand_as(safe), safe), 0.0)
    raise ValueError(f"threshold mode {mode!r}: the kernel takes soft, hard or garrote")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def swt_fwd_level_2d_mxu_ref(x: torch.Tensor, dec_lo, dec_hi, level: int, scheme: str,
                             out_dtypes=(F32, F32)):
    """One a-trous analysis level on (B, R, C), rows then columns ->
    (a, h, v, d), each (B, R, C); a in ``out_dtypes[0]``, h, v, d in
    ``out_dtypes[1]``."""
    return fwd2d_ref(x, (dec_lo, dec_hi), scheme, out_dtypes, dilation=dilation(level),
                     decimate=False)


def swt_inv_level_2d_mxu_ref(a, h, v, d, rec_lo, rec_hi, level: int, scheme: str,
                             out_dtype=F32, threshold: Threshold = None) -> torch.Tensor:
    """One a-trous synthesis level, 1/2 per pass in the taps, rows then
    columns; ``threshold=(mode, beta)`` first thresholds H, V and D in
    float32."""
    bands = [a.float(), h.float(), v.float(), d.float()]
    if threshold is not None:
        bands[1:] = (fused_threshold(t, *threshold) for t in bands[1:])
    return inv2d_ref(bands, (_half(rec_lo), _half(rec_hi)), scheme, out_dtype,
                     dilation=dilation(level), decimated=False)


def swt_fwd_level_2d_mxu_padded_ref(xp: torch.Tensor, dec_lo, dec_hi, level: int, scheme: str,
                                    out_dtypes=(F32, F32)):
    """One a-trous analysis level on a (B, Rp, Cp) shard that holds its
    halo, rows then columns under ``scheme``, ``out[n] = sum_j frev[j] xp[n
    + j f]`` per axis, no wrap -> (a, h, v, d), each (B, Rp - (hlen - 1) f,
    Cp - (hlen - 1) f), in ``out_dtypes`` as
    :func:`swt_fwd_level_2d_mxu_ref`."""
    f = dilation(level)
    return fwd2d_ref(xp, (dec_lo, dec_hi), scheme, out_dtypes,
                     lambda d, fl, ax: conv.padded_atrous_analysis_pass(d, fl, ax, f))


def swt_inv_level_2d_mxu_padded_ref(a, h, v, d, rec_lo, rec_hi, level: int, scheme: str,
                                    out_dtype=F32) -> torch.Tensor:
    """One a-trous synthesis level on (B, Rp, Cp) subbands that hold their
    halo, 1/2 per pass in the taps, rows then columns under ``scheme``, no
    wrap, no threshold -> (B, Rp - (hlen - 1) f, Cp - (hlen - 1) f) in
    ``out_dtype``."""
    f = dilation(level)
    return inv2d_ref((a, h, v, d), (_half(rec_lo), _half(rec_hi)), scheme, out_dtype,
                     lambda u, fl, ax: conv.padded_atrous_synthesis_pass(u, fl, ax, f))


# ---------------------------------------------------------------------------
# launch plans of the two kernels (csrc/swt_matmul.cu)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def swt_fwd_launch_plan(B: int, R: int, C: int, hlen: int, f: int, scheme: str) -> InvPlan:
    """The launch of one a-trous analysis level on a (B, R, C) image
    (kernel 13: output step 1, dilation f; ``_launch.fwd_plan``)."""
    return fwd_plan(B, R, C, hlen, f, scheme, 1)


#: taps per chunk of the inverse's strips (swt_matmul.cu: kInvCh)
INV_CHUNK = 8


def _inv_smem(scheme: str, lr: int, lc: int, dc: int, nt: int, nph: int) -> int:
    """swt_matmul.cu: inv_smem -- taps, index tables, band windows (the
    output tile after the row pass), two temps."""
    nd, es = stage_bytes(scheme)
    wr, wc = lr + nt - 1, lc + (nt - 1) * dc
    win = (4 if nph == 1 else 2) * nd * wr * wc * es
    return (16 * nt + align16(4 * (wr + wc)) + align16(max(win, 4 * lr * (lc + 1)))
            + 2 * nd * lr * temp_pitch(wc, es) * es)


@functools.lru_cache(maxsize=256)
def swt_inv_launch_plan(B: int, R: int, C: int, hlen: int, f: int, scheme: str) -> InvPlan:
    """The launch of one a-trous synthesis level on (B, R, C) subbands.
    Candidates, largest tile first: a tile of lr rows of one residue class
    mod f by lc columns, consecutive or one residue class
    (``consecutive_columns``); all four band windows staged at once
    (nph = 1) or two at a time.  The first that fits two blocks on an SM
    and gives ``block_target`` blocks (kernels/_launch.py: pick_plan)."""
    nt = cdiv(hlen, INV_CHUNK) * INV_CHUNK
    pr = ROW_STRIP[scheme]
    cands = []
    for lr, lc in PLAN_TILES:
        if lr % pr:
            continue
        gc = 1 if consecutive_columns(f, lc, nt - 1) else f
        dc = f // gc
        wc = lc + (nt - 1) * dc
        grid = (cdiv(C, lc) if gc == 1 else axis_blocks(C, f, lc), axis_blocks(R, f, lr),
                min(B, 65535))
        if grid[1] > 65535:
            continue
        for nph in (1, 2):
            items = max((2 // nph) * (lr // pr) * wc, lr * lc // COL_STRIP)
            cands.append(InvPlan(lr, lc, gc, nph, nt, plan_threads(items), grid,
                                 _inv_smem(scheme, lr, lc, dc, nt, nph)))
    return pick_plan(cands, block_target(B, R, C))


def swt_fwd_padded_launch_plan(B: int, Ro: int, Co: int, hlen: int, f: int,
                               scheme: str) -> InvPlan:
    """The launch of kernel 13's padded entry point (kernel 5's in fd) for
    (Ro, Co) outputs: kernel 13's plan for an (Ro, Co) image."""
    return swt_fwd_launch_plan(B, Ro, Co, hlen, f, scheme)


def swt_inv_padded_launch_plan(B: int, R: int, C: int, hlen: int, f: int,
                               scheme: str) -> InvPlan:
    """The launch of kernel 14's padded entry point (kernel 6's in fd) for
    an (R, C) output: kernel 14's plan for (R, C) subbands."""
    return swt_inv_launch_plan(B, R, C, hlen, f, scheme)


# ---------------------------------------------------------------------------
# launchers: one a body and geometry, for every scheme; the exact wrappers
# of kernels/swt.py call them in fd on float32, under their own LAUNCHES
# keys
# ---------------------------------------------------------------------------

def _fwd_launch(key: str, x: torch.Tensor, filters, level: int, scheme: str, det_dtype,
                norm: Norm = None):
    """Kernel 13's body at output step 1 (``csrc/swt_matmul.cu:
    swt_fwd_mxu_kernel``) on a (B, R, C) CUDA image, counted under ``key``
    -> (a float32, h, v, d ``det_dtype``), each (B, R, C).
    ``norm=(mode, beta, partials, approx)`` (fd on float32 only: kernel 5's
    norm launches) also writes the thresholded L1 norm of H, V and D, plus
    sum |A| where ``approx``, into ``partials``, one float32 a block."""
    _check_scheme(scheme)
    f = dilation(level)
    tp = dual_taps(filters, scheme, x.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    B, R, C = x.shape
    pl = swt_fwd_launch_plan(B, R, C, hlen, f, scheme)
    nargs = [0, None, None, 0]
    if norm is not None:
        mode, beta, partials, approx = norm
        if (partials.device != x.device or partials.dtype != F32
                or not partials.is_contiguous() or partials.numel() != math.prod(pl.grid)):
            raise ValueError(f"a norm launch writes {math.prod(pl.grid)} contiguous float32 "
                             f"partials on {x.device}")
        buf = beta_buffer(beta, x.device)
        nargs = [THRESH_CODES[mode], ptr(buf), ptr(partials), int(approx)]
    a = torch.empty_like(x, dtype=F32)
    dets = [torch.empty_like(x, dtype=det_dtype) for _ in range(3)]
    launch(key, x.device,
           [ptr(x), ptr(a), *map(ptr, dets), B, R, C, ptr(tp), hlen, f, conv.fwd_center(hlen),
            SCHEMES.index(scheme), _is_bf16(x.dtype), _is_bf16(det_dtype), pl.lr, pl.lc,
            pl.gc, pl.nph, pl.nt, pl.threads, *pl.grid, pl.smem, *nargs], "swt_fwd_level_2d_mxu")
    return (a, *dets)


def _inv_launch(key: str, a, h, v, d, filters, level: int, scheme: str, out_dtype,
                threshold: Threshold = None) -> torch.Tensor:
    """Kernel 14's body (``csrc/swt_matmul.cu: swt_inv_mxu_kernel``) on
    (B, R, C) CUDA subbands, the 1/2 per pass folded into the taps here,
    ``threshold=(mode, beta)`` fused on H, V and D, counted under ``key``
    -> (B, R, C) in ``out_dtype``."""
    mode, beta = (None, None) if threshold is None else threshold
    _check_scheme(scheme)
    _check_bands(a, h, v, d, key)
    f = dilation(level)
    tp = dual_taps((_half(filters[0]), _half(filters[1])), scheme, a.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    B, R, C = a.shape
    out = torch.empty_like(a, dtype=out_dtype)
    buf = None if mode is None else beta_buffer(beta, a.device)
    pl = swt_inv_launch_plan(B, R, C, hlen, f, scheme)
    launch(key, a.device,
           [*map(ptr, (a, h, v, d, out)), B, R, C, ptr(tp), hlen, f,
            conv.swt_inv_center(hlen), SCHEMES.index(scheme), _is_bf16(h.dtype),
            _is_bf16(out_dtype), THRESH_CODES[mode], None if buf is None else ptr(buf),
            pl.lr, pl.lc, pl.gc, pl.nph, pl.nt, pl.threads, *pl.grid, pl.smem],
           "swt_inv_level_2d_mxu")
    return out


def _fwd_padded_launch(key: str, xp: torch.Tensor, filters, level: int, scheme: str,
                       det_dtype):
    """Kernel 13's body with index tables that do not wrap
    (``csrc/swt_matmul.cu: swt_fwd_padded_kernel``) on a (B, Rp, Cp) CUDA
    shard that holds its halo, counted under ``key`` -> (a float32, h, v, d
    ``det_dtype``), each (B, Rp - (hlen - 1) f, Cp - (hlen - 1) f)."""
    _check_scheme(scheme)
    f = dilation(level)
    tp = dual_taps(filters, scheme, xp.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    B, R, C = xp.shape
    ro, co = conv.padded_atrous_len(R, hlen, f), conv.padded_atrous_len(C, hlen, f)
    pl = swt_fwd_padded_launch_plan(B, ro, co, hlen, f, scheme)
    a = torch.empty((B, ro, co), device=xp.device, dtype=F32)
    dets = [torch.empty((B, ro, co), device=xp.device, dtype=det_dtype) for _ in range(3)]
    launch(key, xp.device,
           [ptr(xp), ptr(a), *map(ptr, dets), B, R, C, ro, co, ptr(tp), hlen, f,
            SCHEMES.index(scheme), _is_bf16(xp.dtype), _is_bf16(det_dtype), pl.lr, pl.lc,
            pl.gc, pl.nph, pl.nt, pl.threads, *pl.grid, pl.smem], "swt_fwd_level_2d_mxu_padded")
    return (a, *dets)


def _inv_padded_launch(key: str, a, h, v, d, filters, level: int, scheme: str,
                       out_dtype) -> torch.Tensor:
    """Kernel 14's body with index tables that do not wrap
    (``csrc/swt_matmul.cu: swt_inv_mxu_kernel<S, true>``) on (B, Rp, Cp)
    CUDA subbands that hold their halo, the 1/2 per pass folded into the
    taps, no threshold, counted under ``key`` -> (B, Rp - (hlen - 1) f, Cp
    - (hlen - 1) f) in ``out_dtype``."""
    _check_scheme(scheme)
    _check_bands(a, h, v, d, key)
    f = dilation(level)
    tp = dual_taps((_half(filters[0]), _half(filters[1])), scheme, a.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    B, Ri, Ci = a.shape
    R, C = conv.padded_atrous_len(Ri, hlen, f), conv.padded_atrous_len(Ci, hlen, f)
    pl = swt_inv_padded_launch_plan(B, R, C, hlen, f, scheme)
    out = torch.empty((B, R, C), device=a.device, dtype=out_dtype)
    launch(key, a.device,
           [*map(ptr, (a, h, v, d, out)), B, Ri, Ci, R, C, ptr(tp), hlen, f,
            SCHEMES.index(scheme), _is_bf16(h.dtype), _is_bf16(out_dtype), pl.lr, pl.lc, pl.gc,
            pl.nph, pl.nt, pl.threads, *pl.grid, pl.smem], "swt_inv_level_2d_mxu_padded")
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@spanned("kernels")
def swt_fwd_level_2d_mxu(x: torch.Tensor, dec_lo, dec_hi, level: int, scheme: str,
                         out_dtypes=(F32, F32)):
    """One a-trous analysis level on a (B, R, C) image (float32 or bf16),
    any size and level, under ``scheme`` -> (a, h, v, d), each (B, R, C);
    a is float32, h, v, d are ``out_dtypes[1]``.  The CUDA kernel takes
    filters of up to 128 taps; ``swt_fwd_launch_plan`` picks its tile."""
    if on_cpu(x, dtypes=_DT):
        return swt_fwd_level_2d_mxu_ref(x, dec_lo, dec_hi, level, scheme, out_dtypes)
    _check_approx(out_dtypes)
    return _fwd_launch("swt_fwd_level_2d_mxu", x, (dec_lo, dec_hi), level, scheme,
                       out_dtypes[1])


@spanned("kernels")
def swt_inv_level_2d_mxu(a, h, v, d, rec_lo, rec_hi, level: int, scheme: str, out_dtype=F32,
                         threshold: Threshold = None) -> torch.Tensor:
    """One a-trous synthesis level under ``scheme``: a float32 (B, R, C)
    approximation and h, v, d of one dtype (float32 or bf16) -> (B, R, C)
    in ``out_dtype``.  ``threshold=(mode, beta)``, mode soft, hard or
    garrote, thresholds H, V and D as they are read; beta is a number or a
    one-element tensor.  Not differentiable: see the ``*_ad`` functions.
    The CUDA kernel takes filters of up to 128 taps; ``swt_inv_launch_plan``
    picks its tile."""
    mode, beta = (None, None) if threshold is None else threshold
    if mode not in THRESH_CODES:
        raise ValueError(f"threshold mode {mode!r}: the kernel takes soft, hard or garrote")
    if on_cpu(a, h, v, d, dtypes=_DT):
        return swt_inv_level_2d_mxu_ref(a, h, v, d, rec_lo, rec_hi, level, scheme, out_dtype,
                                        threshold)
    return _inv_launch("swt_inv_level_2d_mxu", a, h, v, d, (rec_lo, rec_hi), level, scheme,
                       out_dtype, threshold)


@spanned("kernels")
def swt_fwd_level_2d_mxu_padded(xp: torch.Tensor, dec_lo, dec_hi, level: int, scheme: str,
                                out_dtypes=(F32, F32)):
    """One a-trous analysis level under ``scheme`` on a (B, Rp, Cp) shard
    (float32 or bf16) that holds its halo (``kernels.swt_fwd_halo``) ->
    (a, h, v, d), each (B, Rp - (hlen - 1) f, Cp - (hlen - 1) f); a float32,
    h, v, d ``out_dtypes[1]``.  The kernel is kernel 13's body with index
    tables that do not wrap (``csrc/swt_matmul.cu: swt_fwd_padded_kernel``),
    on ``swt_fwd_padded_launch_plan``."""
    if on_cpu(xp, dtypes=_DT):
        return swt_fwd_level_2d_mxu_padded_ref(xp, dec_lo, dec_hi, level, scheme, out_dtypes)
    _check_approx(out_dtypes)
    return _fwd_padded_launch("swt_fwd_level_2d_mxu_padded", xp, (dec_lo, dec_hi), level,
                              scheme, out_dtypes[1])


@spanned("kernels")
def swt_inv_level_2d_mxu_padded(a, h, v, d, rec_lo, rec_hi, level: int, scheme: str,
                                out_dtype=F32) -> torch.Tensor:
    """One a-trous synthesis level under ``scheme`` on a float32 (B, Rp,
    Cp) approximation and h, v, d of one dtype that hold their halo
    (``kernels.swt_inv_halo``) -> (B, Rp - (hlen - 1) f, Cp - (hlen - 1) f)
    in ``out_dtype``, the 1/2 per pass folded into the taps, no threshold.
    The kernel is kernel 14's body with index tables that do not wrap
    (``csrc/swt_matmul.cu: swt_inv_mxu_kernel<S, true>``), on
    ``swt_inv_padded_launch_plan``."""
    if on_cpu(a, h, v, d, dtypes=_DT):
        return swt_inv_level_2d_mxu_padded_ref(a, h, v, d, rec_lo, rec_hi, level, scheme,
                                               out_dtype)
    return _inv_padded_launch("swt_inv_level_2d_mxu_padded", a, h, v, d, (rec_lo, rec_hi),
                              level, scheme, out_dtype)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _SwtFwdLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, level, mode):
        ctx.args = (dec_lo, dec_hi, level)
        ctx.back = swt2d_inv_plan(mode, x.dtype)
        return swt_fwd_level_2d_mxu(x, dec_lo, dec_hi, level, swt_scheme(mode, x.dtype),
                                    mode_out_dtypes(mode))

    @staticmethod
    def backward(ctx, ga, gh, gv, gd):
        lo, hi, level = ctx.args
        y = swt_inv_level_2d_mxu(*_c((ga.float(), gh, gv, gd)), 2.0 * rev(lo), 2.0 * rev(hi),
                                 level, *ctx.back)
        return y, None, None, None, None


def _inv_forward(ctx, a, h, v, d, rec_lo, rec_hi, level, mode, out_dtype, thr=None):
    scheme, out_dtype = swt2d_inv_plan(mode, out_dtype)
    ctx.args = (rec_lo, rec_hi, level)
    ctx.back = (swt_scheme(mode, out_dtype), mode_out_dtypes(mode))
    ctx.in_dtypes = tuple(t.dtype for t in (a, h, v, d))
    if mode == "mixed":
        h, v, d = (t.float() for t in (h, v, d))
    return swt_inv_level_2d_mxu(a.float(), h, v, d, rec_lo, rec_hi, level, scheme, out_dtype,
                                thr)


def _inv_backward(ctx, gy):
    lo, hi, level = ctx.args
    return swt_fwd_level_2d_mxu(gy.contiguous(), 0.5 * rev(lo), 0.5 * rev(hi), level,
                                *ctx.back)


class _SwtInvLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, rec_lo, rec_hi, level, mode, out_dtype):
        return _inv_forward(ctx, a, h, v, d, rec_lo, rec_hi, level, mode, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        res = _inv_backward(ctx, gy)
        return (*(t.to(dt) for t, dt in zip(res, ctx.in_dtypes)), None, None, None, None, None)


def _thresh_vjp_factors(mode: str, t: torch.Tensor, b):
    """(d thresh / d x, d thresh / d beta) where |t| > b, the a.e.
    derivatives of the thresholds (``swt_pallas.py:217-228``); None for a
    zero derivative."""
    if mode == "soft":
        return None, -torch.sign(t)
    if mode == "hard":
        return None, None
    if mode == "garrote":
        safe = torch.where(t == 0, 1.0, t)
        return 1.0 + (b * b) / (safe * safe), -2.0 * b / safe
    raise ValueError(mode)


def thresh_vjp(mode: str, bands, grads, b, beta):
    """The fused threshold's backward (``swt_pallas.py:767-786``): each
    cotangent of ``grads`` through the threshold's a.e. derivative at the
    un-thresholded detail of ``bands``, masked where |detail| > b, and
    beta's gradient where ``beta`` is a tensor (else None), in the dtype of
    ``bands``, ``grads`` and ``b``."""
    outs, gbeta = [], None
    for t, g in zip(bands, grads):
        mask = t.abs() > b
        dfdx, dfdb = _thresh_vjp_factors(mode, t, b)
        outs.append(torch.where(mask, g if dfdx is None else g * dfdx, 0.0))
        if dfdb is not None and isinstance(beta, torch.Tensor):
            term = torch.where(mask, g * dfdb, 0.0).sum()
            gbeta = term if gbeta is None else gbeta + term
    if isinstance(beta, torch.Tensor):
        gbeta = (torch.zeros_like(beta) if gbeta is None
                 else gbeta.to(beta.dtype).reshape(beta.shape))
    return outs, gbeta


class _SwtInvLevel2DMxuDenoise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, beta, rec_lo, rec_hi, level, mode, thr_mode, out_dtype):
        ctx.thr_mode = thr_mode
        ctx.beta_is_tensor = isinstance(beta, torch.Tensor)
        ctx.beta = None if ctx.beta_is_tensor else beta
        ctx.save_for_backward(h, v, d, *([beta] if ctx.beta_is_tensor else []))
        return _inv_forward(ctx, a, h, v, d, rec_lo, rec_hi, level, mode, out_dtype,
                            (thr_mode, beta))

    @staticmethod
    def backward(ctx, gy):
        h, v, d, *rest = ctx.saved_tensors
        beta = rest[0] if ctx.beta_is_tensor else ctx.beta
        ga, *gbands = _inv_backward(ctx, gy)
        b = beta_buffer(beta, gy.device).reshape(())
        outs, gbeta = thresh_vjp(ctx.thr_mode, [t.float() for t in (h, v, d)],
                                 [g.float() for g in gbands], b, beta)
        outs = [g.to(t.dtype) for g, t in zip(outs, (h, v, d))]
        return (ga.to(ctx.in_dtypes[0]), *outs, gbeta, None, None, None, None, None, None)


def swt_fwd_level_2d_mxu_ad(x, dec_lo, dec_hi, level: int, mode: str):
    """Differentiable a-trous analysis level in an MXU ``mode`` ("mixed" or
    "bf16"): the scheme and output dtypes follow the mode and the input
    dtype, as ``swt_matmul_pallas.swt_fwd_level_2d_mxu`` picks them."""
    return _SwtFwdLevel2DMxu.apply(x, dec_lo, dec_hi, level, mode)


def swt_inv_level_2d_mxu_ad(a, h, v, d, rec_lo, rec_hi, level: int, mode: str,
                            out_dtype=None):
    """Differentiable a-trous synthesis level in an MXU ``mode``;
    ``out_dtype`` as in :func:`swt2d_inv_plan`."""
    return _SwtInvLevel2DMxu.apply(a, h, v, d, rec_lo, rec_hi, level, mode, out_dtype)


def swt_inv_level_2d_mxu_denoise_ad(a, h, v, d, beta, rec_lo, rec_hi, level: int, mode: str,
                                    thr_mode: str, out_dtype=None):
    """Differentiable fused threshold + a-trous synthesis level in an MXU
    ``mode``: gradients for the four subbands and, when ``beta`` is a
    tensor, for beta."""
    return _SwtInvLevel2DMxuDenoise.apply(a, h, v, d, beta, rec_lo, rec_hi, level, mode,
                                          thr_mode, out_dtype)
