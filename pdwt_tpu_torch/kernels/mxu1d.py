"""Banded-product level kernels of the precision tiers, batched 1D:
wrappers, plain versions, gradients and the route rule.

Counterpart of ``pdwt_tpu/kernels/mxu1d_pallas.py`` (kernels 15 and 16).
Each level is one pass along the last axis of a (B, N) batch, under a
compute scheme of ``kernels/matmul.py`` (its docstring states each
scheme's arithmetic).  The two kernels of ``csrc/mxu1d.cu``, the analysis
and the synthesis, each on ``band_strip.cuh`` with a launch plan made here
(:func:`fwd1d_launch_plan`, :func:`inv1d_launch_plan`), take four
wrappers:

==========================  ======================================  ==============
wrapper                     computes                                kernel
==========================  ======================================  ==============
``fwd_level_1d_mxu``        decimated analysis, (B, N) -> 2 (B, N/2)  analysis
``swt_fwd_level_1d_mxu``    a-trous analysis at dilation f          analysis
``inv_level_1d_mxu``        polyphase synthesis, 2 (B, M) -> (B, 2M)  synthesis
``swt_inv_level_1d_mxu``    a-trous synthesis, one 1/2 in the taps  synthesis
``*_mxu_padded``            each of the four on an input holding    the same
                            its halo (the ring's), no wrap
==========================  ======================================  ==============

The ``*_mxu_padded`` wrappers are the counterparts of the ``pad_fn=`` of
the four JAX wrappers (``mxu1d_pallas.py:211, 236, 272, 301``), which
JAX's sharded 1D transforms pass their ring halo exchange: the same
bodies with an index table that does not wrap, on the spec of the
``conv.padded_*`` passes.

Each body and geometry has one launcher here (``_fwd_launch``,
``_inv_launch`` and the four padded ones), which takes the scheme and the
``LAUNCHES`` key: the wrappers below call them in their scheme, the exact
wrappers of kernels 7-10 and their padded forms (``kernels/batched1d.py``)
in ``fd`` on float32.

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

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import conv
from ..utils.profiling import spanned
from ._launch import (ROW_STRIP, THRESH_CODES, InvPlan, PadAxis, align16, axis_blocks,
                      beta_buffer, block_target, cdiv, check_span, dilation, launch, on_cpu,
                      pad_axis, pad_positions, pick_plan, poly_geo, ptr, rev, stage_bytes,
                      temp_pitch)
from .matmul import (_DT, BF16, F32, MXU_COLS, MXU_MAX_HLEN, SCHEMES, _check_scheme, _is_bf16,
                     dual_taps, inv_plan, mode_out_dtypes, mode_scheme, scheme_pass, swt_scheme)

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

def _fwd_ref(x, dec_lo, dec_hi, scheme, hi_dtype, pass_fn=None, **kw):
    """The analysis under ``scheme`` with the ``core/conv.py`` pass
    (``kw``: its dilation / decimate) or ``pass_fn(data, filters, axis)``."""
    _check_scheme(scheme)
    pass_fn = pass_fn or (lambda d, f, ax: conv.analysis_pass(d, f, axis=ax, **kw))
    z = scheme_pass(x[:, None, None], (dec_lo, dec_hi), scheme, lambda d, f: pass_fn(d, f, -1))
    return z[:, 0, 0].contiguous(), z[:, 1, 0].to(hi_dtype).contiguous()


def _inv_ref(lo, hi, filters, scheme, out_dtype, pass_fn=None, **kw):
    """The synthesis under ``scheme``, its pass as :func:`_fwd_ref`'s."""
    _check_scheme(scheme)
    pass_fn = pass_fn or (lambda u, f, ax: conv.synthesis_pass(u, f, axis=ax, **kw))
    z = torch.stack([lo.float(), hi.float()], dim=1)[:, :, None]
    y = scheme_pass(z, filters, scheme, lambda u, f: pass_fn(u, f, -1))
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


def fwd_level_1d_mxu_padded_ref(xp, dec_lo, dec_hi, scheme: str, hi_dtype=F32):
    """Decimated analysis on (B, Np) signals that hold their extension,
    ``out[n] = sum_j frev[j] xp[2n + j]``, no wrap -> (lo float32, hi
    ``hi_dtype``), each (B, (Np - hlen) // 2 + 1)."""
    return _fwd_ref(xp, dec_lo, dec_hi, scheme, hi_dtype, conv.padded_analysis_pass)


def swt_fwd_level_1d_mxu_padded_ref(xp, dec_lo, dec_hi, level: int, scheme: str,
                                    hi_dtype=F32):
    """A-trous analysis on (B, Np) signals that hold their halo, ``out[n] =
    sum_j frev[j] xp[n + j f]``, no wrap -> two (B, Np - (hlen - 1) f)."""
    f = dilation(level)
    return _fwd_ref(xp, dec_lo, dec_hi, scheme, hi_dtype,
                    lambda d, fl, ax: conv.padded_atrous_analysis_pass(d, fl, ax, f))


def inv_level_1d_mxu_padded_ref(lo, hi, rec_lo, rec_hi, scheme: str, c0: int, out_len: int,
                                out_dtype=F32):
    """Polyphase synthesis of two (B, M) bands that hold their periodic
    halo, no wrap: ``conv.padded_synthesis_pass`` at offset ``c0`` -> (B,
    out_len)."""
    return _inv_ref(lo, hi, (rec_lo, rec_hi), scheme, out_dtype,
                    lambda u, fl, ax: conv.padded_synthesis_pass(u, fl, ax, c0, out_len))


def swt_inv_level_1d_mxu_padded_ref(lo, hi, rec_lo, rec_hi, level: int, scheme: str,
                                    out_dtype=F32):
    """A-trous synthesis with one 1/2 of two (B, Mp) bands that hold their
    halo, no wrap -> (B, Mp - (hlen - 1) f)."""
    f = dilation(level)
    return _inv_ref(lo, hi, (_half(rec_lo), _half(rec_hi)), scheme, out_dtype,
                    lambda u, fl, ax: conv.padded_atrous_synthesis_pass(u, fl, ax, f))


# ---------------------------------------------------------------------------
# launch plans of the two kernels (csrc/mxu1d.cu)
# ---------------------------------------------------------------------------

#: signals per block of both kernels, one per lane (mxu1d.cu: kRows)
INV_ROWS = 32
#: taps per chunk of the synthesis's strips, polyphase and a-trous (mxu1d.cu: kCh)
INV_CHUNK = {True: 4, False: 8}
#: taps per chunk of the analysis's strips (mxu1d.cu: kFwdCh)
FWD_CHUNK = 8
#: shared memory a block may take and still share its SM with two more
SMEM_THREE_BLOCKS = 75 * 1024
#: position tiles of both kernels, largest first
INV_TILES = (256, 128, 64, 32)


def inv1d_taps(hlen: int, decimated: bool):
    """(taps per parity on the common origin, parity offsets from it) of
    the synthesis: polyphase, parity q's taps p_q + 2b (b < nb_q) start
    o_q - min(o) samples after the window's origin; a-trous, one phase of
    all hlen taps."""
    if not decimated:
        return hlen, (0,)
    g = conv.poly_geometry(hlen)
    sh = tuple(o - min(g.o) for o in g.o)
    return max(s + n for s, n in zip(sh, g.nb)), sh


def _inv1d_smem(scheme: str, nph: int, lc: int, dc: int, nt: int) -> int:
    """mxu1d.cu: inv1d_smem -- taps, the index table, both bands' windows,
    the output tile."""
    nd, es = stage_bytes(scheme)
    w = lc + (nt - 1) * dc
    return (16 * nph * nt + align16(4 * w) + align16(2 * nd * INV_ROWS * temp_pitch(w, es) * es)
            + 4 * INV_ROWS * ((nph * lc) | 1))


def _traffic(plan: InvPlan, w: int, f: int, m: int) -> float:
    """Bytes a plan's staging moves from L2 per position of a signal, in
    4-byte samples, for a window of w samples a block: consecutive
    positions read their window whole; one residue class mod f reads one
    32-byte sector per sample once f >= 8 (f samples' worth below); tiles
    past the end of a class count too."""
    return plan.grid[0] * w * (1 if plan.gc == 1 else min(f, 8)) / m


def _plans_by_traffic(cands, f: int, m: int, window) -> list:
    """Candidates ordered as both 1D plans try them: those that let three
    blocks share an SM first, then by the staging's L2 traffic, the larger
    tile first on a tie."""
    return sorted(cands, key=lambda pl: (pl.smem > SMEM_THREE_BLOCKS,
                                         _traffic(pl, window(pl), f, m), -pl.lc))


@functools.lru_cache(maxsize=256)
def inv1d_launch_plan(B: int, M: int, hlen: int, f: int, scheme: str,
                      decimated: bool) -> InvPlan:
    """The launch of one synthesis level on (B, M) bands, polyphase
    (``decimated``, f = 1) or a-trous at dilation f: 32 signals (lr) by lc
    band positions per block, consecutive or one residue class mod f
    (always consecutive when decimated), the taps padded to nt.  Unlike the
    2D plans, which keep consecutive columns while the window grows at most
    1.4x, a 1D residue class strides through memory, so the candidates are
    ordered by the staging's L2 traffic per position (``_traffic``), the
    larger tile first on a tie, after those that let three blocks share an
    SM (the block's staging, strips and store are fenced by barriers, and
    three or four blocks in other phases hide them better than two: timed
    fastest at every level of the cells on an H100, PERF.md section 6).
    The first that fits two blocks on an SM and gives ``block_target``
    blocks for the output wins (128 at least on the cells' deepest
    levels), so the deep levels take shorter tiles and a dilation of
    thousands takes one residue class.  Always 256 threads, as the other
    strip kernels."""
    need, _ = inv1d_taps(hlen, decimated)
    nt = cdiv(need, INV_CHUNK[decimated]) * INV_CHUNK[decimated]
    nph, p = (2 if decimated else 1), ROW_STRIP[scheme]
    cands = []
    for lc in INV_TILES:
        for gc in ((1,) if decimated or f == 1 else (1, f)):
            dc = f // gc
            if lc % (p * dc):
                continue
            grid = (cdiv(M, lc) if gc == 1 else axis_blocks(M, f, lc),
                    min(cdiv(B, INV_ROWS), 65535), 1)
            cands.append(InvPlan(INV_ROWS, lc, gc, 1, nt, 256, grid,
                                 _inv1d_smem(scheme, nph, lc, dc, nt)))
    cands = _plans_by_traffic(cands, f, M, lambda pl: pl.lc + (pl.nt - 1) * (f // pl.gc))
    return pick_plan(cands, block_target(1, B, nph * M))


def _fwd1d_smem(scheme: str, os_: int, lc: int, dc: int, nt: int) -> int:
    """mxu1d.cu: fwd1d_smem -- taps, the index table, the window, the two
    output tiles."""
    nd, es = stage_bytes(scheme)
    w = os_ * (lc - 1) + (nt - 1) * dc + 1
    return (16 * nt + align16(4 * w) + align16(nd * INV_ROWS * temp_pitch(w, es) * es)
            + 8 * INV_ROWS * (lc | 1))


@functools.lru_cache(maxsize=256)
def fwd1d_launch_plan(B: int, N: int, hlen: int, f: int, scheme: str,
                      decimated: bool) -> InvPlan:
    """The launch of one analysis level on (B, N) signals, decimated (f =
    1, N even, N/2 outputs a signal) or a-trous at dilation f: 32 signals
    (lr) by lc output positions per block, consecutive or one residue class
    mod f (always consecutive when decimated), the taps padded to nt.  The
    synthesis's rule (:func:`inv1d_launch_plan`): candidates by the three
    blocks an SM, then the staging's L2 traffic, then the larger tile; the
    first that fits two blocks on an SM and gives ``block_target`` blocks
    for the output wins, so the deep levels take shorter tiles and a
    dilation of thousands takes one residue class.  Always 256 threads."""
    nt = cdiv(hlen, FWD_CHUNK) * FWD_CHUNK
    os_, p = (2 if decimated else 1), ROW_STRIP[scheme]
    n_out = N // os_
    cands = []
    for lc in INV_TILES:
        for gc in ((1,) if decimated or f == 1 else (1, f)):
            dc = f // gc
            if lc % (p * dc):
                continue
            grid = (cdiv(n_out, lc) if gc == 1 else axis_blocks(n_out, f, lc),
                    min(cdiv(B, INV_ROWS), 65535), 1)
            cands.append(InvPlan(INV_ROWS, lc, gc, 1, nt, 256, grid,
                                 _fwd1d_smem(scheme, os_, lc, dc, nt)))
    cands = _plans_by_traffic(cands, f, N,
                              lambda pl: os_ * (pl.lc - 1) + (pl.nt - 1) * (f // pl.gc) + 1)
    return pick_plan(cands, block_target(1, B, n_out))


def fwd1d_padded_launch_plan(B: int, n_out: int, hlen: int, scheme: str) -> InvPlan:
    """Kernel 15's decimated plan for ``n_out`` outputs a signal (in fd,
    kernel 7's padded plan)."""
    return fwd1d_launch_plan(B, 2 * n_out, hlen, 1, scheme, True)


def inv1d_padded_launch_plan(B: int, pa: PadAxis, hlen: int, scheme: str) -> InvPlan:
    """Kernel 16's polyphase plan for the positions the padded grid covers
    (``pad_positions``; in fd, kernel 8's padded plan)."""
    return inv1d_launch_plan(B, pad_positions(pa), hlen, 1, scheme, True)


def swt_fwd1d_padded_launch_plan(B: int, n_out: int, hlen: int, f: int,
                                 scheme: str) -> InvPlan:
    """Kernel 15's a-trous plan for ``n_out`` outputs a signal (in fd,
    kernel 9's padded plan)."""
    return fwd1d_launch_plan(B, n_out, hlen, f, scheme, False)


def swt_inv1d_padded_launch_plan(B: int, n_out: int, hlen: int, f: int,
                                 scheme: str) -> InvPlan:
    """Kernel 16's a-trous plan for ``n_out`` outputs a signal (in fd,
    kernel 10's padded plan)."""
    return inv1d_launch_plan(B, n_out, hlen, f, scheme, False)


# ---------------------------------------------------------------------------
# launchers: one a body and geometry, for every scheme; the exact wrappers
# of kernels/batched1d.py call them in fd on float32, under their own
# LAUNCHES keys
# ---------------------------------------------------------------------------

#: (mode, beta) of a norm launch of kernel 7
Norm1D = Tuple[str, object]


def _fwd_launch(key: str, x, filters, scheme, hi_dtype, f, cen, decimated: bool,
                norm: Optional[Norm1D] = None):
    """The analysis body (``csrc/mxu1d.cu: fwd1d_strip_kernel``),
    decimated (N even) or a-trous at dilation f, on (B, N) CUDA signals,
    counted under ``key`` -> (lo float32, hi ``hi_dtype``).
    ``norm=(mode, beta)`` (decimated, fd on float32 only: kernel 7's norm
    launches, ``pdwt_fwd_level_1d_norm``) stores hi thresholded at beta and
    appends the float32 partials of its L1 norm, one a block of the plan."""
    _check_scheme(scheme)
    B, n = x.shape
    if decimated and n % 2:
        raise ValueError(f"{key} takes an even length, got {n}")
    tp = dual_taps(filters, scheme, x.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    pl = fwd1d_launch_plan(B, n, hlen, f, scheme, decimated)
    n_out = n // 2 if decimated else n
    out = (torch.empty((B, n_out), device=x.device, dtype=F32),
           torch.empty((B, n_out), device=x.device, dtype=hi_dtype))
    entry, nargs = ("fwd_level_1d_mxu" if decimated else "swt_fwd_level_1d_mxu"), ()
    if norm is not None:
        out += (torch.empty(math.prod(pl.grid), device=x.device, dtype=F32),)
        entry = "fwd_level_1d_norm"
        nargs = (THRESH_CODES[norm[0]], ptr(beta_buffer(norm[1], x.device)), ptr(out[2]))
    launch(key, x.device,
           [ptr(x), ptr(out[0]), ptr(out[1]), B, n, ptr(tp), hlen, f, cen,
            SCHEMES.index(scheme), _is_bf16(x.dtype), _is_bf16(hi_dtype), pl.lc, pl.gc, pl.nt,
            pl.threads, *pl.grid, pl.smem, *nargs], entry)
    return out


def _inv_launch(key: str, lo, hi, filters, scheme, out_dtype, f, cen, decimated: bool):
    """The synthesis body (``csrc/mxu1d.cu: inv1d_strip_kernel``),
    polyphase or a-trous at dilation f, on two (B, M) CUDA bands, counted
    under ``key`` -> (B, 2M) or (B, M) in ``out_dtype``."""
    _check_scheme(scheme)
    _check_pair(lo, hi)
    B, m = lo.shape
    tp = dual_taps(filters, scheme, lo.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    pl = inv1d_launch_plan(B, m, hlen, f, scheme, decimated)
    out = torch.empty((B, 2 * m if decimated else m), device=lo.device, dtype=out_dtype)
    geo = poly_geo(hlen)  # read by the polyphase kernel only
    launch(key, lo.device,
           [ptr(lo), ptr(hi), ptr(out), B, m, ptr(tp), hlen, f, cen, ptr(geo),
            SCHEMES.index(scheme), _is_bf16(hi.dtype), _is_bf16(out_dtype), pl.lc, pl.gc, pl.nt,
            pl.threads, *pl.grid, pl.smem],
           "inv_level_1d_mxu" if decimated else "swt_inv_level_1d_mxu")
    return out


def _check_pair(lo: torch.Tensor, hi: torch.Tensor) -> None:
    if lo.shape != hi.shape:
        raise ValueError(f"the two bands must have one shape, got {tuple(lo.shape)} "
                         f"and {tuple(hi.shape)}")
    if lo.dtype != F32:
        raise ValueError("the banded-product kernels take a float32 low band")


def _fwd_padded_launch(key: str, xp, filters, scheme, hi_dtype):
    """Kernel 15's decimated body with an index table that does not wrap
    (``csrc/mxu1d.cu: fwd1d_strip_kernel<S, 2, true>``) on (B, Np) CUDA
    signals that hold their extension, counted under ``key`` -> (lo
    float32, hi ``hi_dtype``), each (B, (Np - hlen) // 2 + 1)."""
    _check_scheme(scheme)
    B, n = xp.shape
    tp = dual_taps(filters, scheme, xp.device)
    hlen = tp.shape[1]
    n_out = conv.padded_len(n, hlen)
    pl = fwd1d_padded_launch_plan(B, n_out, hlen, scheme)
    lo = torch.empty((B, n_out), device=xp.device, dtype=F32)
    hi = torch.empty((B, n_out), device=xp.device, dtype=hi_dtype)
    launch(key, xp.device,
           [ptr(xp), ptr(lo), ptr(hi), B, n, n_out, ptr(tp), hlen, SCHEMES.index(scheme),
            _is_bf16(xp.dtype), _is_bf16(hi_dtype), pl.lc, pl.gc, pl.nt, pl.threads, *pl.grid,
            pl.smem], "fwd_level_1d_mxu_padded")
    return lo, hi


def _swt_fwd_padded_launch(key: str, xp, filters, level: int, scheme, hi_dtype):
    """Kernel 15's a-trous body with an index table that does not wrap on
    (B, Np) CUDA signals that hold their halo, counted under ``key`` -> (lo
    float32, hi ``hi_dtype``), each (B, Np - (hlen - 1) f)."""
    _check_scheme(scheme)
    f = dilation(level)
    B, n = xp.shape
    tp = dual_taps(filters, scheme, xp.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    n_out = conv.padded_atrous_len(n, hlen, f)
    pl = swt_fwd1d_padded_launch_plan(B, n_out, hlen, f, scheme)
    lo = torch.empty((B, n_out), device=xp.device, dtype=F32)
    hi = torch.empty((B, n_out), device=xp.device, dtype=hi_dtype)
    launch(key, xp.device,
           [ptr(xp), ptr(lo), ptr(hi), B, n, n_out, ptr(tp), hlen, f, SCHEMES.index(scheme),
            _is_bf16(xp.dtype), _is_bf16(hi_dtype), pl.lc, pl.gc, pl.nt, pl.threads, *pl.grid,
            pl.smem], "swt_fwd_level_1d_mxu_padded")
    return lo, hi


def _inv_padded_launch(key: str, lo, hi, filters, scheme, c0: int, out_len: int, out_dtype):
    """Kernel 16's polyphase body with an index table that does not wrap
    (``csrc/mxu1d.cu: inv1d_strip_kernel<S, 2, true>``) on two (B, M) CUDA
    bands that hold their boundary, counted under ``key`` -> (B, out_len)
    in ``out_dtype``.  Raises where an output would read outside the
    bands."""
    _check_scheme(scheme)
    _check_pair(lo, hi)
    B, m = lo.shape
    tp = dual_taps(filters, scheme, lo.device)
    hlen = tp.shape[1]
    conv.check_padded_synthesis(m, hlen, c0, out_len)
    pa = pad_axis(hlen, c0, out_len)
    pl = inv1d_padded_launch_plan(B, pa, hlen, scheme)
    pad = np.array(pa, dtype=np.int32)
    geo = poly_geo(hlen)
    out = torch.empty((B, out_len), device=lo.device, dtype=out_dtype)
    launch(key, lo.device,
           [ptr(lo), ptr(hi), ptr(out), B, m, ptr(pad), ptr(tp), hlen, ptr(geo),
            SCHEMES.index(scheme), _is_bf16(hi.dtype), _is_bf16(out_dtype), pl.lc, pl.gc, pl.nt,
            pl.threads, *pl.grid, pl.smem], "inv_level_1d_mxu_padded")
    return out


def _swt_inv_padded_launch(key: str, lo, hi, filters, level: int, scheme, out_dtype):
    """Kernel 16's a-trous body with an index table that does not wrap on
    two (B, Mp) CUDA bands that hold their halo, the one 1/2 folded into
    the taps here, counted under ``key`` -> (B, Mp - (hlen - 1) f) in
    ``out_dtype``."""
    _check_scheme(scheme)
    _check_pair(lo, hi)
    f = dilation(level)
    B, m = lo.shape
    tp = dual_taps((_half(filters[0]), _half(filters[1])), scheme, lo.device)
    hlen = tp.shape[1]
    check_span(hlen, f)
    n_out = conv.padded_atrous_len(m, hlen, f)
    pl = swt_inv1d_padded_launch_plan(B, n_out, hlen, f, scheme)
    out = torch.empty((B, n_out), device=lo.device, dtype=out_dtype)
    launch(key, lo.device,
           [ptr(lo), ptr(hi), ptr(out), B, m, n_out, ptr(tp), hlen, f, SCHEMES.index(scheme),
            _is_bf16(hi.dtype), _is_bf16(out_dtype), pl.lc, pl.gc, pl.nt, pl.threads, *pl.grid,
            pl.smem], "swt_inv_level_1d_mxu_padded")
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@spanned("kernels")
def fwd_level_1d_mxu(x: torch.Tensor, dec_lo, dec_hi, scheme: str, hi_dtype=F32):
    """Decimated analysis on (B, N), N even, float32 or bf16 -> (lo, hi),
    each (B, N/2); lo float32, hi ``hi_dtype``."""
    if on_cpu(x, ndim=2, dtypes=_DT):
        return fwd_level_1d_mxu_ref(x, dec_lo, dec_hi, scheme, hi_dtype)
    return _fwd_launch("fwd_level_1d_mxu", x, (dec_lo, dec_hi), scheme, hi_dtype, 1,
                       conv.fwd_center(len(dec_lo)), True)


@spanned("kernels")
def swt_fwd_level_1d_mxu(x: torch.Tensor, dec_lo, dec_hi, level: int, scheme: str,
                         hi_dtype=F32):
    """A-trous analysis on (B, N), any N -> (lo, hi), each (B, N)."""
    if on_cpu(x, ndim=2, dtypes=_DT):
        return swt_fwd_level_1d_mxu_ref(x, dec_lo, dec_hi, level, scheme, hi_dtype)
    f = dilation(level)
    return _fwd_launch("swt_fwd_level_1d_mxu", x, (dec_lo, dec_hi), scheme, hi_dtype, f,
                       conv.fwd_center(len(dec_lo)) * f, False)


@spanned("kernels")
def inv_level_1d_mxu(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, scheme: str,
                     out_dtype=F32) -> torch.Tensor:
    """Polyphase synthesis: a float32 low band and a float32 or bf16 high
    band, each (B, M) -> (B, 2M) in ``out_dtype``."""
    if on_cpu(lo, hi, ndim=2, dtypes=_DT):
        return inv_level_1d_mxu_ref(lo, hi, rec_lo, rec_hi, scheme, out_dtype)
    return _inv_launch("inv_level_1d_mxu", lo, hi, (rec_lo, rec_hi), scheme, out_dtype, 1, 0,
                       True)


@spanned("kernels")
def swt_inv_level_1d_mxu(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, level: int,
                         scheme: str, out_dtype=F32) -> torch.Tensor:
    """A-trous synthesis, 2 x (B, N) -> (B, N), the one 1/2 of a 1D
    synthesis folded into the taps before they are rounded."""
    if on_cpu(lo, hi, ndim=2, dtypes=_DT):
        return swt_inv_level_1d_mxu_ref(lo, hi, rec_lo, rec_hi, level, scheme, out_dtype)
    f = dilation(level)
    return _inv_launch("swt_inv_level_1d_mxu", lo, hi, (_half(rec_lo), _half(rec_hi)),
                       scheme, out_dtype, f, conv.swt_inv_center(len(rec_lo)) * f, False)


@spanned("kernels")
def fwd_level_1d_mxu_padded(xp: torch.Tensor, dec_lo, dec_hi, scheme: str, hi_dtype=F32):
    """Decimated analysis under ``scheme`` on (B, Np) signals (float32 or
    bf16) that hold their extension -> (lo, hi), each (B, (Np - hlen) // 2
    + 1); lo float32, hi ``hi_dtype``.  Kernel 15's decimated body with an
    index table that does not wrap (``csrc/mxu1d.cu:
    fwd1d_strip_kernel<S, 2, true>``), on ``fwd1d_padded_launch_plan``."""
    if on_cpu(xp, ndim=2, dtypes=_DT):
        return fwd_level_1d_mxu_padded_ref(xp, dec_lo, dec_hi, scheme, hi_dtype)
    return _fwd_padded_launch("fwd_level_1d_mxu_padded", xp, (dec_lo, dec_hi), scheme,
                              hi_dtype)


@spanned("kernels")
def swt_fwd_level_1d_mxu_padded(xp: torch.Tensor, dec_lo, dec_hi, level: int, scheme: str,
                                hi_dtype=F32):
    """A-trous analysis under ``scheme`` on (B, Np) signals (float32 or
    bf16) that hold their halo (``kernels.swt_fwd_halo``) -> (lo, hi), each
    (B, Np - (hlen - 1) f).  Kernel 15's a-trous body with an index table
    that does not wrap, on ``swt_fwd1d_padded_launch_plan``."""
    if on_cpu(xp, ndim=2, dtypes=_DT):
        return swt_fwd_level_1d_mxu_padded_ref(xp, dec_lo, dec_hi, level, scheme, hi_dtype)
    return _swt_fwd_padded_launch("swt_fwd_level_1d_mxu_padded", xp, (dec_lo, dec_hi), level,
                                  scheme, hi_dtype)


@spanned("kernels")
def inv_level_1d_mxu_padded(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi, scheme: str,
                            c0: int, out_len: int, out_dtype=F32) -> torch.Tensor:
    """Polyphase synthesis under ``scheme`` of a float32 low band and a
    float32 or bf16 high band, each (B, M), that hold their periodic halo
    -> (B, out_len) in ``out_dtype``, the spec of
    :func:`inv_level_1d_mxu_padded_ref`.  Kernel 16's polyphase body with
    an index table that does not wrap (``csrc/mxu1d.cu:
    inv1d_strip_kernel<S, 2, true>``), on ``inv1d_padded_launch_plan``.
    Raises where an output would read outside the bands."""
    if on_cpu(lo, hi, ndim=2, dtypes=_DT):
        return inv_level_1d_mxu_padded_ref(lo, hi, rec_lo, rec_hi, scheme, c0, out_len,
                                           out_dtype)
    return _inv_padded_launch("inv_level_1d_mxu_padded", lo, hi, (rec_lo, rec_hi), scheme, c0,
                              out_len, out_dtype)


@spanned("kernels")
def swt_inv_level_1d_mxu_padded(lo: torch.Tensor, hi: torch.Tensor, rec_lo, rec_hi,
                                level: int, scheme: str, out_dtype=F32) -> torch.Tensor:
    """A-trous synthesis under ``scheme`` of a float32 low band and a
    float32 or bf16 high band, each (B, Mp), that hold their halo
    (``kernels.swt_inv_halo``) -> (B, Mp - (hlen - 1) f) in ``out_dtype``,
    the one 1/2 folded into the taps.  Kernel 16's a-trous body with an
    index table that does not wrap, on ``swt_inv1d_padded_launch_plan``."""
    if on_cpu(lo, hi, ndim=2, dtypes=_DT):
        return swt_inv_level_1d_mxu_padded_ref(lo, hi, rec_lo, rec_hi, level, scheme,
                                               out_dtype)
    return _swt_inv_padded_launch("swt_inv_level_1d_mxu_padded", lo, hi, (rec_lo, rec_hi),
                                  level, scheme, out_dtype)


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
