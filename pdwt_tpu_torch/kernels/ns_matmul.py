"""Banded-product level kernels of the rank-r non-separable engine: the
route rules, wrappers, plain versions and gradients.

Counterpart of ``pdwt_tpu/kernels/ns_matmul_pallas.py`` (kernels 17 and
18).  Genuinely 2D quads run as the separable sum
``Q_s = sum_k outer(a_k^(s), b_k)`` of ``core/nonseparable.py:_rank_decomp``:
``A`` (4, r, hlen) holds the row filters a_k^(s), ``Bc`` (r, hlen) the
column filters b_k, all forward-convention float64.  The CUDA kernels
(``csrc/ns_matmul.cu``, one forward body for both strides and one inverse
body for both syntheses, as on the TPU) and the plain versions here compute
a level under a compute scheme of ``kernels/matmul.py``:

=============================  ============================================
wrapper                        computes
=============================  ============================================
``ns_fwd_level_2d_mxu``        decimated analysis, (B, R, C) -> 4 (B, R/2, C/2)
``ns_swt_fwd_level_2d_mxu``    a-trous analysis at level L, 4 (B, R, C)
``ns_inv_level_2d_mxu``        polyphase synthesis, 4 (B, M, N) -> (B, 2M, 2N)
``ns_swt_inv_level_2d_mxu``    a-trous synthesis, the 1/4 on the b_k
=============================  ============================================

The order of the sums is the TPU kernels' (``ns_matmul_pallas.py:100-136,
206-243``): the analysis filters along the COLUMNS first, t_k = x * b_k,
then each subband sums its row filters over (k, tap) in one float32 sum per
scheme term; the synthesis runs, for each k, one row synthesis summing the
four subbands (s, tap), then one column synthesis summing the k terms
(k, tap).  Each ``<wrapper>_ref`` is its plain version; a wrapper given a
CPU tensor returns it, given a CUDA tensor it launches its kernel or raises
(the kernels take ranks up to 4 and filters up to 40 taps, the route's).

Gradients (``ns_matmul_pallas.py:547-674``): the adjoint of the rank-r sum
is the rank-r synthesis with every filter reversed, and vice versa; the
a-trous pair carries ``4 * b_k`` / ``0.25 * b_k``, which cancel the
inverse's 1/4.  The schemes follow the mode as the JAX wrappers pick them;
the a-trous synthesis runs fd at every level under ``bf16``, whatever the
rung (``ns_matmul_pallas.py:477-479``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..core import conv
from ..utils.profiling import spanned
from ._launch import (COL_STRIP, PLAN_TILES, ROW_STRIP, InvPlan, _c, align16, axis_blocks,
                      block_target, cdiv, check_span, consecutive_columns, dilation, launch,
                      on_cpu, pick_plan, plan_threads, ptr, rev, stage_bytes, temp_pitch)
from .matmul import (_DT, BF16, F32, MXU_MAX_HLEN, SCHEMES, _check_scheme, _is_bf16, inv_plan,
                     mode_out_dtypes, mode_scheme, mxu_route_2d, scheme_pass, scheme_taps,
                     swt_scheme, tile_candidates)

#: the largest rank the kernels take (``ns_matmul_pallas.py:42``)
MAX_RANK = 4


def mxu_route_ns_2d(mr: int, mc: int, hlen: int, rank: int) -> bool:
    """Does a decimated rank-``rank`` level with (mr, mc) subbands take the
    banded-product kernels?  The gates of ``ns_fwd_level_2d_mxu`` and
    ``ns_inv_level_2d_mxu`` (``ns_matmul_pallas.py:173-177, 279-293``): rank
    at most 4 and the 2D decimated route (the forward also needs an even
    image).  Their VMEM estimates never bind for 40 taps or fewer
    (tested against JAX)."""
    return rank <= MAX_RANK and mxu_route_2d(mr, mc, hlen)


def mxu_route_ns_swt_2d(r: int, c: int, hlen: int, rank: int, level: int, scheme: str) -> bool:
    """Does an a-trous rank-``rank`` level on (r, c) images under ``scheme``
    take the banded-product kernels?  The gates of ``ns_swt_*_level_2d_mxu``
    (``ns_matmul_pallas.py:403-417, 471-493``): rank at most 4, an even
    filter of at most 40 taps, and the FIRST TPU tile of the scheme's order
    that divides (r, c) must have a row tile TR with the dilated span
    ``(hlen-1) * 2^(level-1)`` at most 2 TR.  Unlike the separable a-trous
    gate, a later tile that would fit does not count."""
    if hlen % 2 or hlen > MXU_MAX_HLEN or rank > MAX_RANK:
        return False
    for tr, tc in tile_candidates(scheme):
        if r % tr == 0 and c % tc == 0:
            return (hlen - 1) * dilation(level) <= 2 * tr
    return False


def ns_swt_inv_plan(mode: str, out_dtype: Optional[torch.dtype]):
    """(scheme, output dtype) of an a-trous rank-r synthesis level:
    ``mixed`` b3 into float32, ``bf16`` fd into bf16 unless ``out_dtype``
    says otherwise."""
    if mode == "mixed":
        return "b3", F32
    if mode == "bf16":
        return "fd", BF16 if out_dtype is None else out_dtype
    raise ValueError(f"unknown MXU mode {mode!r}")


def _rank_filters(A, Bc):
    """(A, Bc) as float64 arrays of shapes (4, r, hlen) and (r, hlen)."""
    A, Bc = np.asarray(A, dtype=np.float64), np.asarray(Bc, dtype=np.float64)
    if A.ndim != 3 or A.shape[0] != 4 or Bc.ndim != 2 or A.shape[1:] != Bc.shape:
        raise ValueError(f"expected row filters (4, r, hlen) and column filters (r, hlen), "
                         f"got {A.shape} and {Bc.shape}")
    return A, Bc


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _band_sum(srcs, taps, axis: int, start: int, step: int, stride: int, n_out: int):
    """sum_k sum_j taps[k][j] * srcs[k][start + j*step + stride*n], n <
    n_out, along ``axis``: one float32 sum, k outer and j inner (the order
    of the TPU kernels' matrix columns)."""
    acc = None
    for src, tk in zip(srcs, taps):
        for j, t in enumerate(tk):
            s0 = start + j * step
            term = float(t) * conv._sl(src, axis, s0, s0 + stride * (n_out - 1) + 1, stride)
            acc = term if acc is None else acc + term
    return acc


def _interleave(outs, axis: int) -> torch.Tensor:
    ax = axis % outs[0].ndim
    shape = list(outs[0].shape)
    shape[ax] *= len(outs)
    return torch.stack(outs, dim=ax + 1).reshape(shape)


def _syn_geometry(hlen: int, f: Optional[int]):
    """(pad lo, pad hi, tap step, phases) of a synthesis pass: per output
    phase (first tap, tap stride, window start).  Polyphase (``f`` None):
    two phases of ``conv.poly_geometry``; a-trous: one phase of all taps,
    dilated by f."""
    if f is None:
        g = conv.poly_geometry(hlen)
        return g.lo, g.hi, 1, [(g.p[q], 2, g.lo + g.o[q]) for q in (0, 1)]
    c = conv.swt_inv_center(hlen) * f
    return c, (hlen - 1) * f - c, f, [(0, 1, 0)]


def _synth(srcs, taps, axis: int, geo, n: int) -> torch.Tensor:
    lo, hi, step, phases = geo
    padded = [conv.wrap_pad(s, axis, lo, hi) for s in srcs]
    outs = [_band_sum(padded, [t[p::ts] for t in taps], axis, start, step, 1, n)
            for p, ts, start in phases]
    return outs[0] if len(outs) == 1 else _interleave(outs, axis)


def _fwd_ref(x, A, Bc, scheme, out_dtypes, stride: int, f: int):
    _check_scheme(scheme)
    A, Bc = _rank_filters(A, Bc)
    rank, hlen = Bc.shape
    c, span = conv.fwd_center(hlen) * f, (hlen - 1) * f
    ro, co = x.shape[-2] // stride, x.shape[-1] // stride

    def cols(d, fl):  # (B, R, C) -> (B, r, R, co), one column filter per k
        dp = conv.wrap_pad(d, -1, c, span - c)
        return torch.stack([_band_sum([dp], [rev(g)], -1, 0, f, stride, co) for g in fl], 1)

    def rows(t, fl):  # (B, r, R, co) -> (B, 4, ro, co); fl[s*r + k] = a_k^(s)
        tp = conv.wrap_pad(t, -2, c, span - c)
        return torch.stack([_band_sum([tp[:, k] for k in range(rank)],
                                      [rev(fl[s * rank + k]) for k in range(rank)],
                                      -2, 0, f, stride, ro) for s in range(4)], 1)

    t = scheme_pass(x, list(Bc), scheme, cols)
    z = scheme_pass(t, [A[s, k] for s in range(4) for k in range(rank)], scheme, rows)
    a_dt, d_dt = out_dtypes
    return (z[:, 0].to(a_dt).contiguous(), *(z[:, s].to(d_dt).contiguous() for s in (1, 2, 3)))


def _inv_ref(bands, A, Bc, scheme, out_dtype, f: Optional[int]):
    _check_scheme(scheme)
    A, Bc = _rank_filters(A, Bc)
    rank, hlen = Bc.shape
    geo = _syn_geometry(hlen, f)
    z = torch.stack([t.float() for t in bands], dim=1)
    m, n = z.shape[-2:]

    def rows(u, fl):  # (B, 4, m, n) -> (B, r, m', n): per k, sum over (s, tap)
        return torch.stack([_synth([u[:, s] for s in range(4)],
                                   [rev(fl[s * rank + k]) for s in range(4)], -2, geo, m)
                            for k in range(rank)], 1)

    def cols(t, fl):  # (B, r, m', n) -> (B, m', n'): sum over (k, tap)
        return _synth([t[:, k] for k in range(rank)], [rev(g) for g in fl], -1, geo, n)

    t = scheme_pass(z, [A[s, k] for s in range(4) for k in range(rank)], scheme, rows)
    return scheme_pass(t, list(Bc), scheme, cols).to(out_dtype).contiguous()


def ns_fwd_level_2d_mxu_ref(x, A, Bc, scheme: str, out_dtypes=(F32, F32)):
    """Decimated analysis of an even (B, R, C) image -> (a, h, v, d), each
    (B, R/2, C/2)."""
    return _fwd_ref(x, A, Bc, scheme, out_dtypes, 2, 1)


def ns_swt_fwd_level_2d_mxu_ref(x, A, Bc, level: int, scheme: str, out_dtypes=(F32, F32)):
    """A-trous analysis at ``level`` -> (a, h, v, d), each (B, R, C)."""
    return _fwd_ref(x, A, Bc, scheme, out_dtypes, 1, dilation(level))


def ns_inv_level_2d_mxu_ref(a, h, v, d, A, Bc, scheme: str, out_dtype=F32):
    """Polyphase synthesis, four (B, M, N) subbands -> (B, 2M, 2N)."""
    return _inv_ref((a, h, v, d), A, Bc, scheme, out_dtype, None)


def ns_swt_inv_level_2d_mxu_ref(a, h, v, d, A, Bc, level: int, scheme: str, out_dtype=F32):
    """A-trous synthesis, the engine's 1/4 on the column filters."""
    return _inv_ref((a, h, v, d), A, 0.25 * np.asarray(Bc, dtype=np.float64), scheme,
                    out_dtype, dilation(level))


# ---------------------------------------------------------------------------
# launch plans of the two kernels (csrc/ns_matmul.cu)
# ---------------------------------------------------------------------------

#: taps per chunk of both kernels' strips (ns_matmul.cu: kCh)
INV_CHUNK = 4


def _fwd_smem(scheme: str, rank: int, st: int, lr: int, lc: int, dc: int, nt: int) -> int:
    """ns_matmul.cu: ns_fwd_smem -- taps, index tables, the window, the
    rank temps."""
    nd, es = stage_bytes(scheme)
    wr, wc = st * (lr - 1) + nt, st * (lc - 1) + (nt - 1) * dc + 1
    return (40 * rank * nt + align16(4 * (wr + wc)) + align16(nd * wr * temp_pitch(wc, es) * es)
            + rank * nd * wr * temp_pitch(lc, es) * es)


@functools.lru_cache(maxsize=256)
def ns_fwd_launch_plan(B: int, R: int, C: int, hlen: int, rank: int, stride: int, f: int,
                       scheme: str) -> InvPlan:
    """The launch of one rank-r analysis level on a (B, R, C) image at
    ``stride`` 2 (f = 1) or 1 (dilation f).  Candidates, largest tile
    first: lr output rows (one residue class mod f) by lc output columns,
    consecutive or one residue class (``consecutive_columns``; always
    consecutive at stride 2); taps padded to nt.  The first that fits two
    blocks on an SM and gives ``block_target`` blocks for the input's
    size, but never more than 128 (about one per SM: a smaller tile pays
    more halo than the SMs it fills win back, as timed on an H100, PERF.md
    section 6), so the deep levels take smaller tiles (128 blocks at 128^2
    outputs of stride 2).  Always 256 threads, as kernel 2's
    plan: more staging loads in flight on the small tiles."""
    nt = cdiv(hlen, INV_CHUNK) * INV_CHUNK
    ro, co = R // stride, C // stride
    p = ROW_STRIP[scheme]
    cands = []
    for lr, lc in PLAN_TILES:
        if lr % p:
            continue
        gc = 1 if stride == 2 or consecutive_columns(f, lc, nt - 1) else f
        dc = f // gc
        grid = (cdiv(co, lc) if gc == 1 else axis_blocks(co, f, lc), axis_blocks(ro, f, lr),
                min(B, 65535))
        if lc % (p * dc) or grid[1] > 65535:
            continue
        cands.append(InvPlan(lr, lc, gc, 1, nt, 256, grid,
                             _fwd_smem(scheme, rank, stride, lr, lc, dc, nt)))
    return pick_plan(cands, min(block_target(B, R, C), 128))


def inv_phases(hlen: int, f: Optional[int]):
    """The kernel's phase array (stride, org, p[0], p[1], nb[0], nb[1],
    off[0], off[1]): polyphase (``f`` None) from ``conv.poly_geometry``,
    else one a-trous phase of all hlen taps."""
    if f is None:
        g = conv.poly_geometry(hlen)
        return [2, g.lo, *g.p, *g.nb, g.lo + g.o[0], g.lo + g.o[1]]
    return [1, conv.swt_inv_center(hlen), 0, 0, hlen, 0, 0, 0]


def _inv_smem(scheme: str, rank: int, st: int, offmax: int, lr: int, lc: int, dc: int,
              nt: int) -> int:
    """ns_matmul.cu: ns_inv_smem -- taps, index tables, band windows (the
    output tile after the row pass), the rank temps."""
    nd, es = stage_bytes(scheme)
    wr, wc = lr + offmax + nt - 1, lc + (offmax + nt - 1) * dc
    win = 4 * nd * wr * wc * es
    tile = 4 * st * lr * (st * lc + 1)
    return (40 * st * rank * nt + align16(4 * (wr + wc)) + align16(max(win, tile))
            + rank * nd * st * lr * temp_pitch(wc, es) * es)


@functools.lru_cache(maxsize=256)
def ns_inv_launch_plan(B: int, Mr: int, Mc: int, hlen: int, rank: int, f: Optional[int],
                       scheme: str) -> InvPlan:
    """The launch of one rank-r synthesis level on (B, Mr, Mc) subbands,
    polyphase (``f`` None) or a-trous at dilation f.  Candidates, largest
    tile first: a tile of lr subband rows (one residue class mod f) by lc
    columns, consecutive or one residue class (``consecutive_columns``).
    The first that fits two blocks on an SM and gives ``block_target``
    blocks, so the deep levels take smaller tiles."""
    st, _, _, _, nb0, nb1, off0, off1 = inv_phases(hlen, f)
    f = f or 1
    nt = cdiv(max(nb0, nb1), INV_CHUNK) * INV_CHUNK
    offmax = max(off0, off1) if st == 2 else off0
    pr = ROW_STRIP[scheme]
    cands = []
    for lr, lc in PLAN_TILES:
        if lr % pr:
            continue
        gc = 1 if consecutive_columns(f, lc, offmax + nt - 1) else f
        dc = f // gc
        wc = lc + (offmax + nt - 1) * dc
        grid = (cdiv(Mc, lc) if gc == 1 else axis_blocks(Mc, f, lc), axis_blocks(Mr, f, lr),
                min(B, 65535))
        if grid[1] > 65535:
            continue
        items = max((lr // pr) * wc, st * lr * (lc // COL_STRIP))
        cands.append(InvPlan(lr, lc, gc, 1, nt, plan_threads(items), grid,
                             _inv_smem(scheme, rank, st, offmax, lr, lc, dc, nt)))
    return pick_plan(cands, block_target(B, st * Mr, st * Mc))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def ns_taps(A, Bc, scheme: str) -> np.ndarray:
    """The kernels' taps, (rank, 5, 2, hlen) float32: filter 0 of term k is
    b_k, filters 1-4 are a_k^(s), each as the scheme's (first, second)
    values in correlation order."""
    A, Bc = _rank_filters(A, Bc)
    rank, hlen = Bc.shape
    out = np.empty((rank, 5, 2, hlen), dtype=np.float32)
    for k in range(rank):
        for g, filt in enumerate([Bc[k]] + [A[s, k] for s in range(4)]):
            t1, t2 = scheme_taps(filt, scheme)
            out[k, g, 0], out[k, g, 1] = t1[::-1], t2[::-1]
    return out


@functools.lru_cache(maxsize=64)
def _taps_on(key, device: str) -> torch.Tensor:
    a_bytes, a_shape, b_bytes, b_shape, scheme = key
    A = np.frombuffer(a_bytes, dtype=np.float64).reshape(a_shape)
    Bc = np.frombuffer(b_bytes, dtype=np.float64).reshape(b_shape)
    return torch.from_numpy(ns_taps(A, Bc, scheme)).to(device)


def _device_taps(A, Bc, scheme: str, device: torch.device) -> torch.Tensor:
    """The taps on ``device``, copied there once per filter set and scheme."""
    A, Bc = _rank_filters(A, Bc)
    rank, hlen = Bc.shape
    if rank > MAX_RANK or not 2 <= hlen <= MXU_MAX_HLEN:
        raise ValueError(f"the rank-r kernels take ranks up to {MAX_RANK} and filters of "
                         f"2..{MXU_MAX_HLEN} taps, got rank {rank}, {hlen} taps")
    key = (A.tobytes(), A.shape, Bc.tobytes(), Bc.shape, scheme)
    return _taps_on(key, str(device))


def _fwd_launch(name, x, A, Bc, scheme, out_dtypes, stride: int, f: int):
    _check_scheme(scheme)
    if out_dtypes[0] != F32:
        raise ValueError("the banded-product kernels keep the approximation in float32")
    B, R, C = x.shape
    if stride == 2 and (R % 2 or C % 2):
        raise ValueError(f"{name} takes even sizes, got {(R, C)}")
    taps = _device_taps(A, Bc, scheme, x.device)
    rank, _, _, hlen = taps.shape
    check_span(hlen, f)
    pl = ns_fwd_launch_plan(B, R, C, hlen, rank, stride, f, scheme)
    shape = (B, R // stride, C // stride)
    a = torch.empty(shape, device=x.device, dtype=F32)
    dets = [torch.empty(shape, device=x.device, dtype=out_dtypes[1]) for _ in range(3)]
    launch(name, x.device,
           [ptr(x), ptr(a), *map(ptr, dets), B, R, C, ptr(taps), hlen, rank, stride, f,
            conv.fwd_center(hlen), SCHEMES.index(scheme), _is_bf16(x.dtype),
            _is_bf16(out_dtypes[1]), pl.lr, pl.lc, pl.gc, pl.nt, pl.threads, *pl.grid, pl.smem])
    return (a, *dets)


def _inv_launch(name, bands, A, Bc, scheme, out_dtype, f: Optional[int]):
    _check_scheme(scheme)
    a, h, v, d = bands
    if not a.shape == h.shape == v.shape == d.shape:
        raise ValueError("the four subbands must have one shape")
    if a.dtype != F32 or not h.dtype == v.dtype == d.dtype:
        raise ValueError(f"{name} takes a float32 approximation and details of one dtype")
    taps = _device_taps(A, Bc, scheme, a.device)
    rank, _, _, hlen = taps.shape
    B, m, n = a.shape
    geo = np.array(inv_phases(hlen, f), dtype=np.int32)
    pl = ns_inv_launch_plan(B, m, n, hlen, rank, f, scheme)
    stride, f = int(geo[0]), f or 1
    check_span(hlen, f)
    out = torch.empty((B, stride * m, stride * n), device=a.device, dtype=out_dtype)
    launch(name, a.device,
           [*map(ptr, (a, h, v, d, out)), B, m, n, ptr(taps), hlen, rank, f, ptr(geo),
            SCHEMES.index(scheme), _is_bf16(h.dtype), _is_bf16(out_dtype), pl.lr, pl.lc, pl.gc,
            pl.nt, pl.threads, *pl.grid, pl.smem])
    return out


@spanned("kernels")
def ns_fwd_level_2d_mxu(x: torch.Tensor, A, Bc, scheme: str, out_dtypes=(F32, F32)):
    """Decimated rank-r analysis of an even (B, R, C) image (float32 or
    bf16) under ``scheme`` -> (a, h, v, d), each (B, R/2, C/2); a is float32,
    h, v, d are ``out_dtypes[1]``."""
    if on_cpu(x, dtypes=_DT):
        return ns_fwd_level_2d_mxu_ref(x, A, Bc, scheme, out_dtypes)
    return _fwd_launch("ns_fwd_level_2d_mxu", x, A, Bc, scheme, out_dtypes, 2, 1)


@spanned("kernels")
def ns_swt_fwd_level_2d_mxu(x: torch.Tensor, A, Bc, level: int, scheme: str,
                            out_dtypes=(F32, F32)):
    """A-trous rank-r analysis of a (B, R, C) image at ``level``, any size
    -> (a, h, v, d), each (B, R, C)."""
    if on_cpu(x, dtypes=_DT):
        return ns_swt_fwd_level_2d_mxu_ref(x, A, Bc, level, scheme, out_dtypes)
    return _fwd_launch("ns_swt_fwd_level_2d_mxu", x, A, Bc, scheme, out_dtypes, 1,
                       dilation(level))


@spanned("kernels")
def ns_inv_level_2d_mxu(a, h, v, d, A, Bc, scheme: str, out_dtype=F32) -> torch.Tensor:
    """Polyphase rank-r synthesis: a float32 (B, M, N) approximation and h,
    v, d of one dtype -> (B, 2M, 2N) in ``out_dtype``."""
    if on_cpu(a, h, v, d, dtypes=_DT):
        return ns_inv_level_2d_mxu_ref(a, h, v, d, A, Bc, scheme, out_dtype)
    return _inv_launch("ns_inv_level_2d_mxu", (a, h, v, d), A, Bc, scheme, out_dtype, None)


@spanned("kernels")
def ns_swt_inv_level_2d_mxu(a, h, v, d, A, Bc, level: int, scheme: str,
                            out_dtype=F32) -> torch.Tensor:
    """A-trous rank-r synthesis at ``level``, four (B, R, C) subbands ->
    (B, R, C); the 1/4 of the engine rides on the column filters."""
    if on_cpu(a, h, v, d, dtypes=_DT):
        return ns_swt_inv_level_2d_mxu_ref(a, h, v, d, A, Bc, level, scheme, out_dtype)
    return _inv_launch("ns_swt_inv_level_2d_mxu", (a, h, v, d), A,
                       0.25 * np.asarray(Bc, dtype=np.float64), scheme, out_dtype,
                       dilation(level))


# ---------------------------------------------------------------------------
# autograd: each backward is the paired wrapper with every filter reversed
# ---------------------------------------------------------------------------

def _reversed(A, Bc):
    A, Bc = _rank_filters(A, Bc)
    return A[..., ::-1].copy(), Bc[:, ::-1].copy()


class _NsFwdLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, A, Bc, mode):
        ctx.filters = _reversed(A, Bc)
        ctx.back = inv_plan(mode, x.dtype)
        return ns_fwd_level_2d_mxu(x, A, Bc, mode_scheme(mode, x.dtype), mode_out_dtypes(mode))

    @staticmethod
    def backward(ctx, ga, gh, gv, gd):
        y = ns_inv_level_2d_mxu(*_c((ga.float(), gh, gv, gd)), *ctx.filters, *ctx.back)
        return y, None, None, None


class _NsInvLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, A, Bc, mode, out_dtype):
        scheme, out_dtype = inv_plan(mode, out_dtype)
        ctx.filters = _reversed(A, Bc)
        ctx.back = (mode_scheme(mode, out_dtype), mode_out_dtypes(mode))
        ctx.in_dtypes = tuple(t.dtype for t in (a, h, v, d))
        if mode == "mixed":
            h, v, d = (t.float() for t in (h, v, d))
        return ns_inv_level_2d_mxu(a.float(), h, v, d, A, Bc, scheme, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        res = ns_fwd_level_2d_mxu(gy.contiguous(), *ctx.filters, *ctx.back)
        return (*(t.to(dt) for t, dt in zip(res, ctx.in_dtypes)), None, None, None, None)


class _NsSwtFwdLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, A, Bc, level, mode):
        A_r, B_r = _reversed(A, Bc)
        ctx.filters = (A_r, 4.0 * B_r)  # the inverse's 1/4 cancelled
        ctx.level = level
        ctx.back = ns_swt_inv_plan(mode, x.dtype)
        return ns_swt_fwd_level_2d_mxu(x, A, Bc, level, swt_scheme(mode, x.dtype),
                                       mode_out_dtypes(mode))

    @staticmethod
    def backward(ctx, ga, gh, gv, gd):
        y = ns_swt_inv_level_2d_mxu(*_c((ga.float(), gh, gv, gd)), *ctx.filters, ctx.level,
                                    *ctx.back)
        return y, None, None, None, None


class _NsSwtInvLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, A, Bc, level, mode, out_dtype):
        scheme, out_dtype = ns_swt_inv_plan(mode, out_dtype)
        A_r, B_r = _reversed(A, Bc)
        ctx.filters = (A_r, 0.25 * B_r)  # the primal applies (A, Bc / 4)
        ctx.level = level
        ctx.back = (swt_scheme(mode, out_dtype), mode_out_dtypes(mode))
        ctx.in_dtypes = tuple(t.dtype for t in (a, h, v, d))
        if mode == "mixed":
            h, v, d = (t.float() for t in (h, v, d))
        return ns_swt_inv_level_2d_mxu(a.float(), h, v, d, A, Bc, level, scheme, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        res = ns_swt_fwd_level_2d_mxu(gy.contiguous(), *ctx.filters, ctx.level, *ctx.back)
        return (*(t.to(dt) for t, dt in zip(res, ctx.in_dtypes)), None, None, None, None, None)


def ns_fwd_level_2d_mxu_ad(x, A, Bc, mode: str):
    """Differentiable decimated rank-r analysis in an MXU ``mode``."""
    return _NsFwdLevel2DMxu.apply(x, A, Bc, mode)


def ns_inv_level_2d_mxu_ad(a, h, v, d, A, Bc, mode: str, out_dtype=None):
    """Differentiable polyphase rank-r synthesis in an MXU ``mode``;
    ``out_dtype`` as in ``matmul.inv_plan``."""
    return _NsInvLevel2DMxu.apply(a, h, v, d, A, Bc, mode, out_dtype)


def ns_swt_fwd_level_2d_mxu_ad(x, A, Bc, level: int, mode: str):
    """Differentiable a-trous rank-r analysis in an MXU ``mode``."""
    return _NsSwtFwdLevel2DMxu.apply(x, A, Bc, level, mode)


def ns_swt_inv_level_2d_mxu_ad(a, h, v, d, A, Bc, level: int, mode: str, out_dtype=None):
    """Differentiable a-trous rank-r synthesis in an MXU ``mode``;
    ``out_dtype`` as in :func:`ns_swt_inv_plan`."""
    return _NsSwtInvLevel2DMxu.apply(a, h, v, d, A, Bc, level, mode, out_dtype)
