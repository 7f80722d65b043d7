"""Fused separable DWT level kernels: wrappers, plain versions, gradients.

Counterpart of ``pdwt_tpu/kernels/separable_pallas.py``.  Four CUDA
kernels carry the 2D periodization main path:

=========================  ==========================================  ==============================
wrapper                    computes                                    plain version
=========================  ==========================================  ==============================
``fwd_level_2d``           one analysis level, both passes fused       ``fwd_level_2d_ref``
``inv_level_2d``           one synthesis level, both passes fused      ``inv_level_2d_ref``
``fwd_tail_2d``            all remaining analysis levels, one launch   ``fwd_tail_2d_ref``
``inv_tail_2d``            the k deepest synthesis levels, one launch  ``inv_tail_2d_ref``
``fwd_level_2d_padded``    kernel 1 on an input holding its extension  ``fwd_level_2d_padded_ref``
``inv_level_2d_padded``    kernel 2 on padded subbands, no wrap        ``inv_level_2d_padded_ref``
=========================  ==========================================  ==============================

A wrapper given a CPU tensor returns its plain version, built on
``core/conv.py``; given a CUDA tensor it launches its kernel or raises.
Each launch adds one to ``LAUNCHES[<wrapper name>]`` (one dict for
every kernel of the package, in ``_launch.py``).

The two levels are kernels 11's and 12's functions in the ``fd`` scheme
on float32 data, so on CUDA tensors they are those kernels' launches
(``kernels/matmul.py``: ``_fwd_launch``, ``_inv_launch`` and the padded
two) in ``fd``, counted under their own ``LAUNCHES`` keys.  The analysis
level runs kernel 13's body at output step 2 (``csrc/swt_matmul.cu:
swt_fwd_mxu_kernel``) on the plan of ``matmul.fwd_launch_plan``, rows
first as the Pallas kernel (``separable_pallas.py:272-283``); its plain
version runs the columns first, so the two agree to float32 roundoff.  The
synthesis level runs ``inv_level_kernel`` (``csrc/separable.cu``) on the
plan of ``matmul.inv_level_launch_plan``.  The tails (entry points in
``csrc/separable.cu``) run those two levels' per-tile work
(the forward ``fwd_tile<FD, 2>``, the inverse a copy of
``inv_level_kernel<FD>``'s) level by level in one launch, a batch item's
levels spread over the blocks of one thread-block cluster that meet at a
cluster barrier between levels, on the plan of ``tail_launch_plan``; so
each tail level equals the level kernel bit for bit on finite data.  All
four read their taps from ``dual_taps``.

The padded wrappers are the counterparts of
``separable_pallas.py:355 fwd_level_2d_padded`` and ``:498
inv_level_2d_padded``, for the boundary modes (``core/separable.py``'s
mode route): the same bodies (``csrc/swt_matmul.cu: fwd_padded_kernel`` on
``fwd_tile<FD, 2, true>``, ``csrc/separable.cu: inv_level_kernel<FD,
true>``) with index tables that do not wrap, on the spec of
``conv.padded_analysis_pass`` and ``conv.padded_synthesis_pass``.  The
synthesis's offset ``c0`` in the zero-stuffed domain becomes the periodic
body's ``base`` and ``off`` per axis (``_launch.pad_axis``), and exactly
the requested outputs are written.  Their autograd Functions run the
kernels forward; the backward is the exact adjoint through the plain
versions (``torch.func.vjp``), as JAX's mode route transposes its fma
formulation (``pdwt_tpu/core/separable.py:437-481``).

Filters are forward-convention float64 arrays (``dec_lo``/``dec_hi`` for
analysis, ``rec_lo``/``rec_hi`` for synthesis), as in the JAX kernels; the
reversal to correlation order happens here.

Gradients: the transforms are linear, and the adjoint of the analysis with
filters f is the synthesis with filters f[::-1] (for periodization on even
sizes the synthesis shift ``inv_shift(hlen)`` equals ``hlen - 1 -
fwd_center(hlen)``, for odd as for even ``hlen``).  So each ``*_ad``
autograd Function's backward is the paired kernel with reversed taps.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

import torch

from ..core import conv
from ..utils.profiling import spanned
from ._launch import LAUNCHES, MAX_HLEN, PadAxis, reset_launch_counts  # noqa: F401 (re-exported)
from ._launch import (FWD_CHUNK, FWD_TILES, PLAN_TILES, SMEM_LIMIT, SMS, InvPlan, _c, cdiv,
                      dual_taps, fwd_smem, launch, on_cpu, poly_geo, ptr, rev)
from .matmul import (F32, INV_CHUNK, _fwd_launch, _fwd_padded_launch, _inv_launch,
                     _inv_padded_launch, _inv_smem, fwd_launch_plan, inv_level_launch_plan)

#: Most levels one tail launch fuses (PDWT_MAX_TAIL_LEVELS).
MAX_TAIL_LEVELS = 16
#: Dynamic shared memory one block may use on Hopper (227 KiB).
SMEM_PER_BLOCK = 232448


Bands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain versions (core/conv.py), any device, float32 or float64
# ---------------------------------------------------------------------------

def fwd_level_2d_ref(x: torch.Tensor, dec_lo, dec_hi):
    """One analysis level on (B, R, C): columns, then rows."""
    dec = (dec_lo, dec_hi)
    z = conv.analysis_pass(x[:, None], dec, axis=-1)
    z = conv.analysis_pass(z, dec, axis=-2)
    return tuple(z[:, k].contiguous() for k in range(4))


def inv_level_2d_ref(a, h, v, d, rec_lo, rec_hi) -> torch.Tensor:
    """One synthesis level, (B, Mr, Mc) subbands -> (B, 2Mr, 2Mc): rows,
    then columns."""
    rec = (rec_lo, rec_hi)
    z = torch.stack([a, h, v, d], dim=1)
    t = conv.synthesis_pass(z, rec, axis=-2)
    return conv.synthesis_pass(t, rec, axis=-1)[:, 0].contiguous()


def fwd_tail_2d_ref(x, dec_lo, dec_hi, levels: int):
    dets = []
    a = x
    for _ in range(levels):
        a, h, v, d = fwd_level_2d_ref(a, dec_lo, dec_hi)
        dets.append((h, v, d))
    return a, dets


def inv_tail_2d_ref(a, details: Sequence[Bands], rec_lo, rec_hi):
    """``details`` deepest level first."""
    for (h, v, d) in details:
        a = inv_level_2d_ref(a, h, v, d, rec_lo, rec_hi)
    return a


def fwd_level_2d_padded_ref(xp: torch.Tensor, dec_lo, dec_hi):
    """One analysis level on a (B, Rp, Cp) input that holds its boundary
    extension: ``out[n] = sum_j frev[j] xp[2n + j]`` along the columns,
    then the rows, no wrap -> four (B, (Rp - hlen) // 2 + 1, (Cp - hlen) //
    2 + 1) subbands."""
    dec = (dec_lo, dec_hi)
    z = conv.padded_analysis_pass(xp[:, None], dec, axis=-1)
    z = conv.padded_analysis_pass(z, dec, axis=-2)
    return tuple(z[:, k].contiguous() for k in range(4))


def inv_level_2d_padded_ref(a, h, v, d, rec_lo, rec_hi, c0: Tuple[int, int],
                            out_shape: Tuple[int, int]) -> torch.Tensor:
    """One synthesis level on (B, Mr, Mc) subbands that hold their boundary
    (zeros, or the periodic halo), rows then columns, no wrap: along each
    axis ``out[i] = sum_k sum_j rev_k[j] U_k[i + c0 + j]`` for ``i <
    out_len`` (``conv.padded_synthesis_pass``) -> (B, *out_shape)."""
    rec = (rec_lo, rec_hi)
    z = torch.stack([a, h, v, d], dim=1)
    t = conv.padded_synthesis_pass(z, rec, -2, c0[0], out_shape[0])
    return conv.padded_synthesis_pass(t, rec, -1, c0[1], out_shape[1])[:, 0].contiguous()


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def tail_supported(shape: Tuple[int, int], hlen: int, levels: int) -> bool:
    """Can one tail launch run ``levels`` levels on an (r, c) image?  The
    sizes must halve exactly, and the approximation plus its lo/hi temp
    (2*r*c floats) must fit one block's shared memory."""
    r, c = shape
    if levels < 1 or levels > MAX_TAIL_LEVELS or hlen > MAX_HLEN:
        return False
    if r % (1 << levels) or c % (1 << levels):
        return False
    return 2 * r * c * 4 <= SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# launch plan of the tails (kernels 3 and 4)
# ---------------------------------------------------------------------------

#: cluster sizes the tails take (16 needs the card's non-portable opt-in)
TAIL_CLUSTERS = (1, 2, 4, 8, 16)


class TailPlan(NamedTuple):
    """Geometry of one tail launch: ``nb`` blocks per batch item (grid
    ``B * nb``), in clusters of ``cs`` (``nb`` where the launch runs more
    than one level and the item's blocks meet at a cluster barrier between
    levels; 1 where it runs one), threads per block, dynamic shared-memory
    bytes (the largest level's) and, per level in launch order (level 1
    first forward, the deepest first inverse), the level kernel's plan of
    that level: tile (lr, lc), nph, nt and the grid of tiles (x, y, batch),
    tile k on block k mod nb."""
    nb: int
    cs: int
    threads: int
    smem: int
    levels: Tuple[InvPlan, ...]


def _tail_cluster(B: int, first_tiles: int) -> int:
    """The cluster size of a multi-level tail: the largest of
    TAIL_CLUSTERS that the first level's 8 x 8 tiles can keep busy and
    that keeps B clusters within one block per SM (1 from 132 items on)."""
    room = min(first_tiles, max(1, SMS // B))
    return max(c for c in TAIL_CLUSTERS if c <= room)


def _tail_level(cs: int, cands) -> InvPlan:
    """A level's tile among the level kernel's candidates (InvPlans whose
    grid counts the level's tiles): the fewest rounds of tiles per block
    (ceil(tiles / cs)), then the least window staged per block (its
    shared memory), within the card's limit."""
    fits = [p for p in cands if p.smem <= SMEM_LIMIT]
    return min(fits, key=lambda p: (cdiv(p.grid[0] * p.grid[1], cs), p.smem))


@functools.lru_cache(maxsize=256)
def tail_launch_plan(B: int, R: int, C: int, hlen: int, levels: int,
                     inverse: bool = False) -> TailPlan:
    """The launch of a tail over ``levels`` levels of (B, R, C) images (the
    forward's input, the inverse's output): with one level, the level
    kernel's own plan (``matmul.fwd_launch_plan`` / ``inv_level_launch_plan`` in fd:
    a block per tile, no barrier, cs = 1); with more, one cluster of
    ``_tail_cluster`` blocks per item sharing each level's tiles
    (``_tail_level``: the 128^2 db7 level gets 16 x 16 output tiles, one
    per block of a 16-cluster)."""
    if levels < 1 or levels > MAX_TAIL_LEVELS or R % (1 << levels) or C % (1 << levels):
        raise ValueError(f"a tail of {levels} levels takes sizes divisible by 2^{levels}, "
                         f"got {(R, C)}")
    if levels == 1:
        pl = (inv_level_launch_plan(B, R // 2, C // 2, hlen) if inverse
              else fwd_launch_plan(B, R, C, hlen, "fd"))
        return TailPlan(pl.grid[0] * pl.grid[1], 1, pl.threads, pl.smem, (pl,))
    cs = _tail_cluster(B, cdiv(R // 2, 8) * cdiv(C // 2, 8))
    g = conv.poly_geometry(hlen)
    nt = cdiv(max(g.nb), INV_CHUNK) * INV_CHUNK if inverse else cdiv(hlen, FWD_CHUNK) * FWD_CHUNK
    plans = []
    for j in range(levels):
        if inverse:  # subbands (mr, mc) of the deepest level first
            mr, mc = R >> (levels - j), C >> (levels - j)
            cands = [InvPlan(lr, lc, 1, 1, nt, 256, (cdiv(mc, lc), cdiv(mr, lr), min(B, 65535)),
                             _inv_smem(g.lo + max(g.o), lr, lc, nt)) for lr, lc in PLAN_TILES]
        else:  # outputs (ro, co) of level j + 1
            ro, co = R >> (j + 1), C >> (j + 1)
            cands = [InvPlan(lr, lc, 1, nph, nt, 256, (cdiv(co, lc), cdiv(ro, lr), min(B, 65535)),
                             fwd_smem("fd", lr, lc, 1, nt, nph, 2))
                     for lr, lc in FWD_TILES for nph in (1, 2)]
        plans.append(_tail_level(cs, cands))
    return TailPlan(cs, cs, 256, max(p.smem for p in plans), tuple(plans))


def _tail_args(pl: TailPlan) -> list:
    """The plan as the tail entry points take it: nb, cs, nt, threads,
    smem and the int32 array of (lr, lc, nph) per level (kept alive by the
    caller)."""
    tiles = np.array([(p.lr, p.lc, p.nph) for p in pl.levels], dtype=np.int32)
    return [pl.nb, pl.cs, pl.levels[0].nt, pl.threads, pl.smem, tiles]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@spanned("kernels")
def fwd_level_2d(x: torch.Tensor, dec_lo, dec_hi):
    """One analysis level on an even-sized (B, R, C) image -> (a, h, v, d),
    each (B, R/2, C/2).  On a CUDA tensor, kernel 11's launch in fd
    (``matmul.fwd_launch_plan`` picks its tile); filters of 2..128 taps."""
    if on_cpu(x):
        return fwd_level_2d_ref(x, dec_lo, dec_hi)
    return _fwd_launch("fwd_level_2d", x, (dec_lo, dec_hi), "fd", F32)


@spanned("kernels")
def inv_level_2d(a, h, v, d, rec_lo, rec_hi) -> torch.Tensor:
    """One synthesis level: (B, Mr, Mc) subbands -> (B, 2Mr, 2Mc).  On CUDA
    tensors, kernel 12's launch in fd (``inv_level_launch_plan`` picks its
    tile); filters of 2..128 taps."""
    if on_cpu(a, h, v, d):
        return inv_level_2d_ref(a, h, v, d, rec_lo, rec_hi)
    return _inv_launch("inv_level_2d", a, h, v, d, (rec_lo, rec_hi), "fd", F32)


@spanned("kernels")
def fwd_tail_2d(x: torch.Tensor, dec_lo, dec_hi, levels: int):
    """All ``levels`` remaining analysis levels of a (B, R, C) image in one
    launch -> (a, [(h, v, d) of level 1, level 2, ...]), on the plan of
    ``tail_launch_plan``."""
    if on_cpu(x):
        return fwd_tail_2d_ref(x, dec_lo, dec_hi, levels)
    B, R, C = x.shape
    if not tail_supported((R, C), len(dec_lo), levels):
        raise ValueError(f"fwd_tail_2d: {levels} levels of {(R, C)} with "
                         f"{len(dec_lo)} taps is not tail_supported")
    tp = dual_taps((dec_lo, dec_hi), "fd", x.device)
    hlen = tp.shape[1]
    pl = tail_launch_plan(B, R, C, hlen, levels)
    new = functools.partial(torch.empty, device=x.device, dtype=x.dtype)
    a = new((B, R >> levels, C >> levels))
    dets: List[Bands] = [tuple(new((B, R >> lvl, C >> lvl)) for _ in range(3))
                         for lvl in range(1, levels + 1)]
    scratch = new(sum(B * (R >> lvl) * (C >> lvl) for lvl in range(1, levels)))
    ptrs = (ctypes.c_void_p * (3 * levels))(*[t.data_ptr() for band in dets for t in band])
    *plan, tiles = _tail_args(pl)
    launch("fwd_tail_2d", x.device,
           [ptr(x), ptr(a), ptr(scratch), ptrs, B, R, C, levels, ptr(tp), hlen,
            conv.fwd_center(hlen), *plan, ptr(tiles)])
    return a, dets


@spanned("kernels")
def inv_tail_2d(a: torch.Tensor, details: Sequence[Bands], rec_lo, rec_hi):
    """Inverse of :func:`fwd_tail_2d`: ``a`` (B, m, m') and ``details``
    (deepest level first) -> (B, m << k, m' << k), k = len(details), on the
    plan of ``tail_launch_plan(..., inverse=True)``."""
    flat = [t for band in details for t in band]
    if on_cpu(a, *flat):
        return inv_tail_2d_ref(a, details, rec_lo, rec_hi)
    levels = len(details)
    B, mr, mc = a.shape
    for lvl, band in enumerate(details):
        want = (B, mr << lvl, mc << lvl)
        if any(tuple(t.shape) != want for t in band):
            raise ValueError(f"inv_tail_2d: level {lvl} (deepest first) must "
                             f"have shape {want}")
    R, C = mr << levels, mc << levels
    if not tail_supported((R, C), len(rec_lo), levels):
        raise ValueError(f"inv_tail_2d: {levels} levels of {(mr, mc)} with "
                         f"{len(rec_lo)} taps is not tail_supported")
    tp = dual_taps((rec_lo, rec_hi), "fd", a.device)
    hlen = tp.shape[1]
    geo = poly_geo(hlen)
    pl = tail_launch_plan(B, R, C, hlen, levels, inverse=True)
    new = functools.partial(torch.empty, device=a.device, dtype=a.dtype)
    out = new((B, R, C))
    scratch = new(sum(B * (R >> lvl) * (C >> lvl) for lvl in range(1, levels)))
    ptrs = (ctypes.c_void_p * (3 * levels))(*[t.data_ptr() for t in flat])
    *plan, tiles = _tail_args(pl)
    launch("inv_tail_2d", a.device,
           [ptr(a), ptrs, ptr(out), ptr(scratch), B, mr, mc, levels, ptr(tp), hlen, ptr(geo),
            *plan, ptr(tiles)])
    return out


@spanned("kernels")
def fwd_level_2d_padded(xp: torch.Tensor, dec_lo, dec_hi):
    """One analysis level on a (B, Rp, Cp) float32 input that holds its
    boundary extension -> (a, h, v, d), each (B, (Rp - hlen) // 2 + 1,
    (Cp - hlen) // 2 + 1): on a CUDA tensor, kernel 11's padded launch in
    fd (``matmul.fwd_padded_launch_plan``)."""
    if on_cpu(xp):
        return fwd_level_2d_padded_ref(xp, dec_lo, dec_hi)
    return _fwd_padded_launch("fwd_level_2d_padded", xp, (dec_lo, dec_hi), "fd", F32)


@spanned("kernels")
def inv_level_2d_padded(a, h, v, d, rec_lo, rec_hi, c0: Tuple[int, int],
                        out_shape: Tuple[int, int]) -> torch.Tensor:
    """One synthesis level on (B, Mr, Mc) float32 subbands that hold their
    boundary -> (B, *out_shape), the spec of ``inv_level_2d_padded_ref``:
    on CUDA tensors, kernel 12's padded launch in fd
    (``matmul.inv_padded_launch_plan``).  Raises where an output would read
    outside the subbands."""
    if on_cpu(a, h, v, d):
        return inv_level_2d_padded_ref(a, h, v, d, rec_lo, rec_hi, c0, out_shape)
    return _inv_padded_launch("inv_level_2d_padded", a, h, v, d, (rec_lo, rec_hi), "fd", c0,
                              out_shape, F32)


# ---------------------------------------------------------------------------
# autograd: each backward is the paired kernel with reversed taps; the
# padded entry points' the exact adjoint through their plain versions
# ---------------------------------------------------------------------------

def meta(t: torch.Tensor):
    """What :func:`plain_vjp` needs of a forward input: shape, dtype, device."""
    return tuple(t.shape), t.dtype, t.device


def plain_vjp(ref, like, cotangents):
    """The adjoint of a linear plain version ``ref`` (one tensor in, of
    the shape, dtype and device ``like`` = :func:`meta`) on
    ``cotangents``."""
    shape, dtype, device = like
    _, vjp = torch.func.vjp(ref, torch.zeros(shape, dtype=dtype, device=device))
    return vjp(cotangents)



class _FwdLevel2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi):
        ctx.filters = (dec_lo, dec_hi)
        return fwd_level_2d(x, dec_lo, dec_hi)

    @staticmethod
    def backward(ctx, ga, gh, gv, gd):
        lo, hi = ctx.filters
        return inv_level_2d(*_c((ga, gh, gv, gd)), rev(lo), rev(hi)), None, None


class _InvLevel2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, rec_lo, rec_hi):
        ctx.filters = (rec_lo, rec_hi)
        return inv_level_2d(a, h, v, d, rec_lo, rec_hi)

    @staticmethod
    def backward(ctx, gy):
        lo, hi = ctx.filters
        return (*fwd_level_2d(gy.contiguous(), rev(lo), rev(hi)), None, None)


class _FwdTail2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, levels):
        ctx.filters = (dec_lo, dec_hi)
        a, dets = fwd_tail_2d(x, dec_lo, dec_hi, levels)
        return (a, *[t for band in dets for t in band])

    @staticmethod
    def backward(ctx, ga, *gdets):
        lo, hi = ctx.filters
        gdets = _c(gdets)
        bands = [tuple(gdets[3 * k:3 * k + 3]) for k in range(len(gdets) // 3)]
        y = inv_tail_2d(ga.contiguous(), bands[::-1], rev(lo), rev(hi))
        return y, None, None, None


class _InvTail2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec_lo, rec_hi, a, *flat):
        ctx.filters = (rec_lo, rec_hi)
        bands = [tuple(flat[3 * k:3 * k + 3]) for k in range(len(flat) // 3)]
        return inv_tail_2d(a, bands, rec_lo, rec_hi)

    @staticmethod
    def backward(ctx, gy):
        lo, hi = ctx.filters
        levels = len(ctx.needs_input_grad[3:]) // 3
        ga, gdets = fwd_tail_2d(gy.contiguous(), rev(lo), rev(hi), levels)
        flat = [t for band in gdets[::-1] for t in band]  # deepest first
        return (None, None, ga, *flat)


class _FwdLevel2DPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, dec_lo, dec_hi):
        ctx.filters = (dec_lo, dec_hi)
        ctx.like = meta(xp)
        return fwd_level_2d_padded(xp, dec_lo, dec_hi)

    @staticmethod
    def backward(ctx, *grads):
        lo, hi = ctx.filters
        (gx,) = plain_vjp(lambda t: fwd_level_2d_padded_ref(t, lo, hi), ctx.like, grads)
        return gx, None, None


class _InvLevel2DPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, rec_lo, rec_hi, c0, out_shape):
        ctx.args = (rec_lo, rec_hi, c0, out_shape)
        ctx.like = ((4,) + tuple(a.shape), a.dtype, a.device)
        return inv_level_2d_padded(a, h, v, d, rec_lo, rec_hi, c0, out_shape)

    @staticmethod
    def backward(ctx, gy):
        lo, hi, c0, shape = ctx.args
        ref = lambda z: inv_level_2d_padded_ref(*z, lo, hi, c0, shape)
        (g,) = plain_vjp(ref, ctx.like, gy.contiguous())
        return (*g, None, None, None, None)


def fwd_level_2d_ad(x, dec_lo, dec_hi):
    """Differentiable :func:`fwd_level_2d`."""
    return _FwdLevel2D.apply(x, dec_lo, dec_hi)


def inv_level_2d_ad(a, h, v, d, rec_lo, rec_hi):
    """Differentiable :func:`inv_level_2d`."""
    return _InvLevel2D.apply(a, h, v, d, rec_lo, rec_hi)


def fwd_tail_2d_ad(x, dec_lo, dec_hi, levels: int):
    """Differentiable :func:`fwd_tail_2d`."""
    outs = _FwdTail2D.apply(x, dec_lo, dec_hi, levels)
    return outs[0], [tuple(outs[1 + 3 * k:4 + 3 * k]) for k in range(levels)]


def inv_tail_2d_ad(a, details: Sequence[Bands], rec_lo, rec_hi):
    """Differentiable :func:`inv_tail_2d` (``details`` deepest first)."""
    return _InvTail2D.apply(rec_lo, rec_hi, a, *[t for band in details for t in band])


def fwd_level_2d_padded_ad(xp, dec_lo, dec_hi):
    """Differentiable :func:`fwd_level_2d_padded`."""
    return _FwdLevel2DPadded.apply(xp, dec_lo, dec_hi)


def inv_level_2d_padded_ad(a, h, v, d, rec_lo, rec_hi, c0: Tuple[int, int],
                           out_shape: Tuple[int, int]):
    """Differentiable :func:`inv_level_2d_padded`."""
    return _InvLevel2DPadded.apply(a, h, v, d, rec_lo, rec_hi, tuple(c0), tuple(out_shape))
