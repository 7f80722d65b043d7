"""Banded-product level kernels of the precision tiers, 2D: the compute
schemes, the route rule, wrappers, plain versions and gradients.

Counterpart of ``pdwt_tpu/kernels/matmul_pallas.py`` (kernels 11 and 12)
and of the scheme helpers of ``swt_matmul_pallas.py:111-159``.  On the TPU
a decimating dual FIR runs as a banded matrix product on the MXU; what the
product computes is fixed by its compute scheme, and that is what the CUDA
kernels (entry points in ``csrc/matmul.cu``: the analysis runs kernel 13's
body at output step 2 in ``csrc/swt_matmul.cu``, the synthesis kernel 2's
body in ``csrc/separable.cu``) and the plain versions here reproduce:

===========================  ====================================  =============================
wrapper                      computes                              plain version
===========================  ====================================  =============================
``fwd_level_2d_mxu``         one analysis level, rows then columns ``fwd_level_2d_mxu_ref``
``inv_level_2d_mxu``         one synthesis level, rows then cols   ``inv_level_2d_mxu_ref``
``fwd_level_2d_mxu_padded``  11 on an input holding its halo       ``fwd_level_2d_mxu_padded_ref``
``inv_level_2d_mxu_padded``  12 on padded subbands, no wrap        ``inv_level_2d_mxu_padded_ref``
===========================  ====================================  =============================

The padded entry points are the counterparts of the ``pad_fn=`` of
``matmul_pallas.py:306 fwd_level_2d_mxu`` and ``:442 inv_level_2d_mxu``,
which JAX's sharded DWT passes its ring halo exchange: the same bodies
with index tables that do not wrap, on inputs the caller padded, on the
spec of ``conv.padded_analysis_pass`` and ``conv.padded_synthesis_pass``.
No autograd: JAX's ``*_mxu_ad`` take no ``pad_fn``.

Each body and geometry has one launcher here (``_fwd_launch``,
``_inv_launch``, ``_fwd_padded_launch``, ``_inv_padded_launch``), which
takes the scheme and the ``LAUNCHES`` key: the wrappers below call them in
their scheme, the exact wrappers of kernels 1 and 2 and their padded forms
(``kernels/separable.py``) in ``fd`` on float32.

Schemes.  Each pass pairs constant taps f with data x; every product of
two bf16 values is exact in float32 and every sum is float32.  h() rounds
to bf16 (nearest even), x_h = h(x), x_l = h(x - x_h), and f_h, f_l split
the float32 tap the same way (taps go float64 -> float32 -> bf16, as the
TPU's float32 band matrices do):

======  ====================================================
b1      sum h(f) h(x)
fd      sum f x in float32 (on the TPU one bf16 pass; the port
        follows JAX on the CPU)
b2f     sum f_h h(x) + sum f_l h(x)
b2d     sum f_h x_h + sum f_h x_l
b3      sum f_h x_h + sum f_h x_l + sum f_l x_h
======  ====================================================

The terms are summed in that order, each over its taps in correlation
order (the plain version's order).  A 2D level runs rows (axis -2) first,
then columns, and the float32 row-pass result is split per scheme before
the column pass (for b1/b2f it is rounded to bf16).  Outputs are rounded
once, from float32, to their dtype.

A wrapper given a CPU tensor returns its plain version (``core/conv.py``
passes over float32 tensors that hold the rounded values); given a CUDA
tensor it launches its kernel or raises.

Gradients (``matmul_pallas.py:502-555``): the backward of each level is
the paired wrapper with reversed taps in the same mode, its output in the
forward input's dtype.  The schemes are fixed when the forward runs.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import conv, precision
from ..utils.profiling import spanned
from ._launch import (PLAN_TILES, ROW_STRIP, InvPlan, PadAxis, _c, align16, block_target, cdiv,
                      dual_taps, fwd_plan, launch, on_cpu, pad_axis, pad_positions, pick_plan,
                      poly_geo, ptr, rev, scheme_taps, stage_bytes, temp_pitch)
from ._launch import kernel_taps  # noqa: F401 -- the plan tests' model of the taps

F32, BF16 = torch.float32, torch.bfloat16
SCHEMES = ("b1", "fd", "b2f", "b2d", "b3")
#: schemes whose taps ship as a bf16 (hi, lo) split and sum several terms
PAIR_SCHEMES = ("b3", "b2f", "b2d")
#: (tap, data) index of each term: tap 0 is f_h (f for fd), tap 1 f_l;
#: data 0 is h(x) (x for fd), data 1 x_l
_TERMS = {"b1": ((0, 0),), "fd": ((0, 0),), "b2f": ((0, 0), (1, 0)),
          "b2d": ((0, 0), (0, 1)), "b3": ((0, 0), (0, 1), (1, 0))}
#: bf16 rung -> (forward, inverse) scheme of the bf16 level-1 passes
_BF16_TIERS = {"fast": ("b1", "fd"), "balanced": ("b2f", "b2f"),
               "accurate": ("b3", "b3")}
#: longest filter and tile divisors of the MXU route (matmul_pallas.py:71-97)
MXU_MAX_HLEN, MXU_ROWS, MXU_COLS = 40, 32, 128
#: the TPU tiles (TR, TC) in the order the MXU kernels try them
#: (matmul_pallas.py:71-86): b3 the small ones first, the others the big ones
TILES_BIG = ((128, 256), (128, 128), (64, 128), (32, 128))
TILES_SMALL = ((64, 128), (32, 128), (128, 128), (128, 256))


# ---------------------------------------------------------------------------
# schemes and the route rule
# ---------------------------------------------------------------------------

def bf16_l1_schemes() -> Tuple[str, str]:
    """(forward, inverse) scheme of the bf16 level-1 passes under the
    active bf16 rung."""
    return _BF16_TIERS[precision.bf16_accuracy()]


def mode_scheme(mode: str, in_dtype: torch.dtype) -> str:
    """Forward scheme of a decimated level: ``mixed`` runs b3; ``bf16``
    runs the rung's level-1 scheme on bf16 input and b3 on the float32
    approximation chain."""
    if mode == "mixed":
        return "b3"
    if mode == "bf16":
        return bf16_l1_schemes()[0] if in_dtype == BF16 else "b3"
    raise ValueError(f"unknown MXU mode {mode!r}")


def swt_bf16_scheme(default: str) -> str:
    """A-trous bf16 scheme: b2f under the balanced and accurate rungs,
    else ``default``."""
    return "b2f" if precision.bf16_accuracy() != "fast" else default


def swt_scheme(mode: str, in_dtype: torch.dtype) -> str:
    """Forward scheme of an a-trous level: ``mixed`` b3; ``bf16`` one pass
    (b1 on bf16 input, fd on float32) unless the rung asks for b2f."""
    if mode == "mixed":
        return "b3"
    if mode == "bf16":
        return swt_bf16_scheme("b1" if in_dtype == BF16 else "fd")
    raise ValueError(f"unknown MXU mode {mode!r}")


def inv_plan(mode: str, out_dtype: Optional[torch.dtype]) -> Tuple[str, torch.dtype]:
    """(scheme, output dtype) of a decimated synthesis level: ``mixed`` b3
    into float32; ``bf16`` the rung's inverse scheme where the output is
    bf16 (the last level), b3 into float32 on the deep levels."""
    if mode == "mixed":
        return "b3", F32
    if mode == "bf16":
        out = BF16 if out_dtype is None else out_dtype
        return (bf16_l1_schemes()[1] if out == BF16 else "b3"), out
    raise ValueError(f"unknown MXU mode {mode!r}")


def mode_out_dtypes(mode: str) -> Tuple[torch.dtype, torch.dtype]:
    """(approximation, detail) dtypes of a forward level: all float32
    under ``mixed``; a float32 approximation chain and bf16 details under
    ``bf16``."""
    return (F32, F32) if mode == "mixed" else (F32, BF16)


def mxu_route_2d(mr: int, mc: int, hlen: int) -> bool:
    """Does a 2D level with (mr, mc) subbands take the banded-product
    kernels?  The gate of ``_pick_mxu_tiles`` (``matmul_pallas.py:89-97``):
    an even filter of at most 40 taps, and subbands that some TPU tile
    (TR in {128, 64, 32}, TC in {256, 128}) divides."""
    return (hlen % 2 == 0 and hlen <= MXU_MAX_HLEN and mr % MXU_ROWS == 0
            and mc % MXU_COLS == 0)


def tile_candidates(scheme: str):
    """The TPU tiles in the order the MXU kernels try them under ``scheme``."""
    return TILES_SMALL if scheme == "b3" else TILES_BIG


def _check_scheme(scheme: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown compute scheme {scheme!r}; expected one of {SCHEMES}")


# ---------------------------------------------------------------------------
# rounding and the scheme's terms (plain versions)
# ---------------------------------------------------------------------------

def split_data(x: torch.Tensor, scheme: str):
    """(first, second) data operands of a scheme as float32 tensors: x for
    fd, h(x) for b1/b2f, (x_h, x_l) for b2d/b3."""
    x = x.float()
    if scheme == "fd":
        return x, None
    xh = x.to(BF16).float()
    if scheme in ("b1", "b2f"):
        return xh, None
    return xh, (x - xh).to(BF16).float()


def scheme_pass(x: torch.Tensor, filters: Sequence, scheme: str, pass_fn) -> torch.Tensor:
    """One pass under a scheme: the sum over its terms, in order, of
    ``pass_fn(data, filters)`` with the term's rounded data and taps."""
    split = [scheme_taps(f, scheme) for f in filters]
    data = split_data(x, scheme)
    out = None
    for ti, di in _TERMS[scheme]:
        y = pass_fn(data[di], [s[ti] for s in split])
        out = y if out is None else out + y
    return out


def fwd2d_ref(x: torch.Tensor, filters, scheme: str, out_dtypes, pass_fn=None, **kw):
    """A 2D analysis level under ``scheme``: rows then columns with the
    ``core/conv.py`` analysis pass (``kw``: its dilation / decimate), or
    ``pass_fn(data, filters, axis)`` (a padded pass) -> (a, h, v, d), a in
    ``out_dtypes[0]``, h, v, d in ``out_dtypes[1]``."""
    _check_scheme(scheme)
    pass_fn = pass_fn or (lambda d, f, ax: conv.analysis_pass(d, f, axis=ax, **kw))
    t = scheme_pass(x[:, None], filters, scheme, lambda d, f: pass_fn(d, f, -2))
    z = scheme_pass(t, filters, scheme, lambda d, f: pass_fn(d, f, -1))
    a_dt, d_dt = out_dtypes
    # channels: lo rows lo cols, lo rows hi cols (V), hi rows lo cols (H), hi hi
    return (z[:, 0].to(a_dt).contiguous(), z[:, 2].to(d_dt).contiguous(),
            z[:, 1].to(d_dt).contiguous(), z[:, 3].to(d_dt).contiguous())


def inv2d_ref(bands, filters, scheme: str, out_dtype, pass_fn=None, **kw) -> torch.Tensor:
    """A 2D synthesis level under ``scheme``: (A, H) and (V, D) along the
    rows, then the two along the columns, with the ``core/conv.py``
    synthesis pass (``kw``: its dilation / decimated), or ``pass_fn(data,
    filters, axis)`` (a padded pass)."""
    _check_scheme(scheme)
    pass_fn = pass_fn or (lambda u, f, ax: conv.synthesis_pass(u, f, axis=ax, **kw))
    z = torch.stack([t.float() for t in bands], dim=1)
    t = scheme_pass(z, filters, scheme, lambda u, f: pass_fn(u, f, -2))
    y = scheme_pass(t, filters, scheme, lambda u, f: pass_fn(u, f, -1))
    return y[:, 0].to(out_dtype).contiguous()


def fwd_level_2d_mxu_ref(x: torch.Tensor, dec_lo, dec_hi, scheme: str,
                         out_dtypes=(F32, F32)):
    """One analysis level on (B, R, C), rows then columns -> (a, h, v, d),
    a in ``out_dtypes[0]``, h, v, d in ``out_dtypes[1]``."""
    return fwd2d_ref(x, (dec_lo, dec_hi), scheme, out_dtypes)


def inv_level_2d_mxu_ref(a, h, v, d, rec_lo, rec_hi, scheme: str,
                         out_dtype=F32) -> torch.Tensor:
    """One synthesis level, (B, Mr, Mc) subbands -> (B, 2Mr, 2Mc), rows
    then columns."""
    return inv2d_ref((a, h, v, d), (rec_lo, rec_hi), scheme, out_dtype)


def fwd_level_2d_mxu_padded_ref(xp: torch.Tensor, dec_lo, dec_hi, scheme: str,
                                out_dtypes=(F32, F32)):
    """One analysis level on a (B, Rp, Cp) input that holds its extension
    (on a shard: the odd extension and the ring halo), rows then columns
    under ``scheme``, ``out[n] = sum_j frev[j] xp[2n + j]`` per axis, no
    wrap -> (a, h, v, d), each (B, (Rp - hlen) // 2 + 1, (Cp - hlen) // 2 +
    1), in ``out_dtypes`` as :func:`fwd_level_2d_mxu_ref`."""
    return fwd2d_ref(xp, (dec_lo, dec_hi), scheme, out_dtypes, conv.padded_analysis_pass)


def inv_level_2d_mxu_padded_ref(a, h, v, d, rec_lo, rec_hi, scheme: str, c0: Tuple[int, int],
                                out_shape: Tuple[int, int], out_dtype=F32) -> torch.Tensor:
    """One synthesis level on (B, Mr, Mc) subbands that hold their periodic
    halo, rows then columns under ``scheme``, no wrap: along each axis
    ``conv.padded_synthesis_pass`` at offset ``c0`` for ``out_shape``
    outputs -> (B, *out_shape) in ``out_dtype``."""
    return inv2d_ref((a, h, v, d), (rec_lo, rec_hi), scheme, out_dtype,
                     lambda u, f, ax: conv.padded_synthesis_pass(u, f, ax, c0[ax + 2],
                                                                 out_shape[ax + 2]))


# ---------------------------------------------------------------------------
# launch plans of the two bodies: kernel 13's at output step 2 (kernels 11
# and 1) and inv_level_kernel (csrc/separable.cu: kernels 12 and 2)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def fwd_launch_plan(B: int, R: int, C: int, hlen: int, scheme: str) -> InvPlan:
    """The launch of one decimated analysis level on an even (B, R, C)
    image (kernels 11 and, in fd, 1 on kernel 13's body: output step 2,
    dilation 1, (R/2, C/2) subbands; ``_launch.fwd_plan``): the DWT cells'
    levels (2048^2 down to 256^2 images) get 128-512 blocks."""
    return fwd_plan(B, R, C, hlen, 1, scheme, 2)


#: taps per chunk of the inverse level's strips (separable.cu: kInvCh)
INV_CHUNK = 4


def _inv_smem(offmax: int, lr: int, lc: int, nt: int, scheme: str = "fd") -> int:
    """separable.cu: inv_smem<S> -- taps (first values, and second values
    where the scheme reads them), index tables, the four band windows (the
    output tile after the row pass), the two temps."""
    nd, es = stage_bytes(scheme)
    nv = 2 if scheme in ("b2f", "b3") else 1
    wr, wc = lr + offmax + nt - 1, lc + offmax + nt - 1
    return (16 * nv * nt + align16(4 * (wr + wc))
            + align16(max(4 * nd * es * wr * wc, 8 * lr * (2 * lc + 1)))
            + 4 * nd * lr * temp_pitch(wc, es) * es)


@functools.lru_cache(maxsize=256)
def inv_level_launch_plan(B: int, Mr: int, Mc: int, hlen: int, scheme: str = "fd") -> InvPlan:
    """The launch of one polyphase synthesis level on (B, Mr, Mc) subbands
    under ``scheme`` (kernel 12; kernel 2 in fd): a tile of lr x lc
    consecutive subband positions, largest first, taps padded to nt per
    parity.  The first that fits two blocks on an SM and gives
    ``block_target`` blocks (kernels/_launch.py: pick_plan), so the deep
    levels take smaller tiles.  Always 256 threads: on the deep levels'
    small tiles, more warps keep more staging loads in flight than the work
    items need threads (timed 20 % faster at 256^2 and 128^2 subbands on an
    H100, PERF.md section 6)."""
    g = conv.poly_geometry(hlen)
    nt = cdiv(max(g.nb), INV_CHUNK) * INV_CHUNK
    offmax = g.lo + max(g.o)
    cands = []
    for lr, lc in PLAN_TILES:
        grid = (cdiv(Mc, lc), cdiv(Mr, lr), min(B, 65535))
        if lr % ROW_STRIP[scheme] or grid[1] > 65535:
            continue
        cands.append(InvPlan(lr, lc, 1, 1, nt, 256, grid, _inv_smem(offmax, lr, lc, nt, scheme)))
    return pick_plan(cands, block_target(B, 2 * Mr, 2 * Mc))


def fwd_padded_launch_plan(B: int, Ro: int, Co: int, hlen: int, scheme: str) -> InvPlan:
    """The launch of kernel 11's padded entry point (kernel 1's in fd) for
    (Ro, Co) outputs: kernel 11's plan for that output size
    (``fwd_launch_plan`` of a (2 Ro, 2 Co) image)."""
    return fwd_launch_plan(B, 2 * Ro, 2 * Co, hlen, scheme)


def inv_padded_launch_plan(B: int, rows: PadAxis, cols: PadAxis, hlen: int,
                           scheme: str) -> InvPlan:
    """The launch of kernel 12's padded entry point (kernel 2's in fd):
    kernel 12's plan for the coefficient positions its grid covers
    (``pad_positions``)."""
    return inv_level_launch_plan(B, pad_positions(rows), pad_positions(cols), hlen, scheme)


# ---------------------------------------------------------------------------
# launchers: one a body and geometry, for every scheme; the exact wrappers
# of kernels/separable.py call them in fd on float32, under their own
# LAUNCHES keys
# ---------------------------------------------------------------------------

_DT = (F32, BF16)


def _is_bf16(dtype: torch.dtype) -> int:
    if dtype not in _DT:
        raise ValueError(f"the banded-product kernels store float32 or bfloat16, got {dtype}")
    return int(dtype == BF16)


def _check_bands(a, h, v, d, name: str) -> None:
    if not a.shape == h.shape == v.shape == d.shape:
        raise ValueError("the four subbands must have one shape")
    if a.dtype != F32 or not h.dtype == v.dtype == d.dtype:
        raise ValueError(f"{name} takes a float32 approximation and details of one dtype")


def _fwd_launch(key: str, x: torch.Tensor, filters, scheme: str, det_dtype):
    """Kernel 13's body at output step 2 (``csrc/swt_matmul.cu:
    swt_fwd_mxu_kernel``) on an even (B, R, C) CUDA image, counted under
    ``key`` -> (a float32, h, v, d ``det_dtype``), each (B, R/2, C/2)."""
    _check_scheme(scheme)
    B, R, C = x.shape
    if R % 2 or C % 2:
        raise ValueError(f"{key} takes even sizes, got {(R, C)}")
    tp = dual_taps(filters, scheme, x.device)
    hlen = tp.shape[1]
    pl = fwd_launch_plan(B, R, C, hlen, scheme)
    a = torch.empty((B, R // 2, C // 2), device=x.device, dtype=F32)
    dets = [torch.empty((B, R // 2, C // 2), device=x.device, dtype=det_dtype)
            for _ in range(3)]
    launch(key, x.device,
           [ptr(x), ptr(a), *map(ptr, dets), B, R, C, ptr(tp), hlen, conv.fwd_center(hlen),
            SCHEMES.index(scheme), _is_bf16(x.dtype), _is_bf16(det_dtype), pl.lr, pl.lc,
            pl.gc, pl.nph, pl.nt, pl.threads, *pl.grid, pl.smem], "fwd_level_2d_mxu")
    return (a, *dets)


def _inv_launch(key: str, a, h, v, d, filters, scheme: str, out_dtype) -> torch.Tensor:
    """``inv_level_kernel`` (``csrc/separable.cu``) on (B, Mr, Mc) CUDA
    subbands, counted under ``key`` -> (B, 2Mr, 2Mc) in ``out_dtype``."""
    _check_scheme(scheme)
    _check_bands(a, h, v, d, key)
    B, mr, mc = a.shape
    tp = dual_taps(filters, scheme, a.device)
    hlen = tp.shape[1]
    geo = poly_geo(hlen)
    pl = inv_level_launch_plan(B, mr, mc, hlen, scheme)
    out = torch.empty((B, 2 * mr, 2 * mc), device=a.device, dtype=out_dtype)
    launch(key, a.device,
           [*map(ptr, (a, h, v, d, out)), B, mr, mc, ptr(tp), hlen, ptr(geo),
            SCHEMES.index(scheme), _is_bf16(h.dtype), _is_bf16(out_dtype), pl.lr, pl.lc, pl.nt,
            pl.threads, *pl.grid, pl.smem], "inv_level_2d_mxu")
    return out


def _fwd_padded_launch(key: str, xp: torch.Tensor, filters, scheme: str, det_dtype):
    """Kernel 11's body with index tables that do not wrap
    (``csrc/swt_matmul.cu: fwd_padded_kernel``) on a (B, Rp, Cp) CUDA input
    that holds its extension, counted under ``key`` -> (a float32, h, v, d
    ``det_dtype``), each (B, (Rp - hlen) // 2 + 1, (Cp - hlen) // 2 + 1)."""
    _check_scheme(scheme)
    B, R, C = xp.shape
    tp = dual_taps(filters, scheme, xp.device)
    hlen = tp.shape[1]
    ro, co = conv.padded_len(R, hlen), conv.padded_len(C, hlen)
    pl = fwd_padded_launch_plan(B, ro, co, hlen, scheme)
    a = torch.empty((B, ro, co), device=xp.device, dtype=F32)
    dets = [torch.empty((B, ro, co), device=xp.device, dtype=det_dtype) for _ in range(3)]
    launch(key, xp.device,
           [ptr(xp), ptr(a), *map(ptr, dets), B, R, C, ro, co, ptr(tp), hlen,
            SCHEMES.index(scheme), _is_bf16(xp.dtype), _is_bf16(det_dtype), pl.lr, pl.lc,
            pl.gc, pl.nph, pl.nt, pl.threads, *pl.grid, pl.smem], "fwd_level_2d_mxu_padded")
    return (a, *dets)


def _inv_padded_launch(key: str, a, h, v, d, filters, scheme: str, c0: Tuple[int, int],
                       out_shape: Tuple[int, int], out_dtype) -> torch.Tensor:
    """Kernel 12's body with index tables that do not wrap
    (``csrc/separable.cu: inv_level_kernel<S, true, true>``) on (B, Mr, Mc)
    CUDA subbands that hold their boundary, counted under ``key`` -> (B,
    *out_shape) in ``out_dtype``.  Raises where an output would read
    outside the subbands."""
    _check_scheme(scheme)
    _check_bands(a, h, v, d, key)
    B, mr, mc = a.shape
    tp = dual_taps(filters, scheme, a.device)
    hlen = tp.shape[1]
    conv.check_padded_synthesis(mr, hlen, c0[0], out_shape[0])
    conv.check_padded_synthesis(mc, hlen, c0[1], out_shape[1])
    rows, cols = (pad_axis(hlen, c, n) for c, n in zip(c0, out_shape))
    pl = inv_padded_launch_plan(B, rows, cols, hlen, scheme)
    pad = np.array([*rows, *cols], dtype=np.int32)
    geo = poly_geo(hlen)
    out = torch.empty((B, *out_shape), device=a.device, dtype=out_dtype)
    launch(key, a.device,
           [*map(ptr, (a, h, v, d, out)), B, mr, mc, ptr(pad), ptr(tp), hlen, ptr(geo),
            SCHEMES.index(scheme), _is_bf16(h.dtype), _is_bf16(out_dtype), pl.lr, pl.lc, pl.nt,
            pl.threads, *pl.grid, pl.smem], "inv_level_2d_mxu_padded")
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_approx(out_dtypes) -> None:
    if out_dtypes[0] != F32:
        raise ValueError("the banded-product kernels keep the approximation in float32")


@spanned("kernels")
def fwd_level_2d_mxu(x: torch.Tensor, dec_lo, dec_hi, scheme: str, out_dtypes=(F32, F32)):
    """One analysis level on an even-sized (B, R, C) image (float32 or
    bf16) under ``scheme`` -> (a, h, v, d), each (B, R/2, C/2); a is
    float32, h, v, d are ``out_dtypes[1]``.  The kernel is kernel 13's body
    at output step 2 (``csrc/swt_matmul.cu: swt_fwd_mxu_kernel``), on the
    plan of ``fwd_launch_plan``; it takes filters of up to 128 taps."""
    if on_cpu(x, dtypes=_DT):
        return fwd_level_2d_mxu_ref(x, dec_lo, dec_hi, scheme, out_dtypes)
    _check_approx(out_dtypes)
    return _fwd_launch("fwd_level_2d_mxu", x, (dec_lo, dec_hi), scheme, out_dtypes[1])


@spanned("kernels")
def fwd_level_2d_mxu_padded(xp: torch.Tensor, dec_lo, dec_hi, scheme: str,
                            out_dtypes=(F32, F32)):
    """One analysis level under ``scheme`` on a (B, Rp, Cp) input (float32
    or bf16) that holds its extension -> (a, h, v, d), each (B, (Rp - hlen)
    // 2 + 1, (Cp - hlen) // 2 + 1); a float32, h, v, d ``out_dtypes[1]``.
    The kernel is kernel 11's body with index tables that do not wrap
    (``csrc/swt_matmul.cu: fwd_padded_kernel``), on
    ``fwd_padded_launch_plan``."""
    if on_cpu(xp, dtypes=_DT):
        return fwd_level_2d_mxu_padded_ref(xp, dec_lo, dec_hi, scheme, out_dtypes)
    _check_approx(out_dtypes)
    return _fwd_padded_launch("fwd_level_2d_mxu_padded", xp, (dec_lo, dec_hi), scheme,
                              out_dtypes[1])


@spanned("kernels")
def inv_level_2d_mxu_padded(a, h, v, d, rec_lo, rec_hi, scheme: str, c0: Tuple[int, int],
                            out_shape: Tuple[int, int], out_dtype=F32) -> torch.Tensor:
    """One synthesis level under ``scheme`` on a float32 (B, Mr, Mc)
    approximation and h, v, d of one dtype that hold their periodic halo
    -> (B, *out_shape) in ``out_dtype``, the spec of
    :func:`inv_level_2d_mxu_padded_ref`.  The kernel is kernel 12's body
    with index tables that do not wrap (``csrc/separable.cu:
    inv_level_kernel<S, true, true>``), on ``inv_padded_launch_plan``.  Raises
    where an output would read outside the subbands."""
    if on_cpu(a, h, v, d, dtypes=_DT):
        return inv_level_2d_mxu_padded_ref(a, h, v, d, rec_lo, rec_hi, scheme, c0, out_shape,
                                           out_dtype)
    return _inv_padded_launch("inv_level_2d_mxu_padded", a, h, v, d, (rec_lo, rec_hi), scheme,
                              c0, out_shape, out_dtype)


@spanned("kernels")
def inv_level_2d_mxu(a, h, v, d, rec_lo, rec_hi, scheme: str, out_dtype=F32) -> torch.Tensor:
    """One synthesis level under ``scheme``: a float32 (B, Mr, Mc)
    approximation and h, v, d of one dtype (float32 or bf16) ->
    (B, 2Mr, 2Mc) in ``out_dtype``.  The kernel is kernel 2's body in the
    scheme (``csrc/separable.cu: inv_level_kernel``), on the plan of
    ``inv_level_launch_plan``."""
    if on_cpu(a, h, v, d, dtypes=_DT):
        return inv_level_2d_mxu_ref(a, h, v, d, rec_lo, rec_hi, scheme, out_dtype)
    return _inv_launch("inv_level_2d_mxu", a, h, v, d, (rec_lo, rec_hi), scheme, out_dtype)


# ---------------------------------------------------------------------------
# autograd: each backward is the paired wrapper with reversed taps
# ---------------------------------------------------------------------------

class _FwdLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi, mode):
        ctx.filters = (dec_lo, dec_hi)
        ctx.back = inv_plan(mode, x.dtype)
        return fwd_level_2d_mxu(x, dec_lo, dec_hi, mode_scheme(mode, x.dtype),
                                mode_out_dtypes(mode))

    @staticmethod
    def backward(ctx, ga, gh, gv, gd):
        lo, hi = ctx.filters
        scheme, out_dtype = ctx.back
        y = inv_level_2d_mxu(*_c((ga.float(), gh, gv, gd)), rev(lo), rev(hi), scheme,
                             out_dtype)
        return y, None, None, None


class _InvLevel2DMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, rec_lo, rec_hi, mode, out_dtype):
        scheme, out_dtype = inv_plan(mode, out_dtype)
        ctx.filters = (rec_lo, rec_hi)
        ctx.back = (mode_scheme(mode, out_dtype), mode_out_dtypes(mode))
        ctx.in_dtypes = tuple(t.dtype for t in (a, h, v, d))
        if mode == "mixed":
            h, v, d = (t.float() for t in (h, v, d))
        return inv_level_2d_mxu(a.float(), h, v, d, rec_lo, rec_hi, scheme, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        lo, hi = ctx.filters
        scheme, out_dtypes = ctx.back
        res = fwd_level_2d_mxu(gy.contiguous(), rev(lo), rev(hi), scheme, out_dtypes)
        return (*(t.to(dt) for t, dt in zip(res, ctx.in_dtypes)), None, None, None, None)


def fwd_level_2d_mxu_ad(x, dec_lo, dec_hi, mode: str):
    """Differentiable forward level in an MXU ``mode`` ("mixed" or
    "bf16"): the scheme and output dtypes follow the mode and the input
    dtype, as ``matmul_pallas.fwd_level_2d_mxu`` picks them."""
    return _FwdLevel2DMxu.apply(x, dec_lo, dec_hi, mode)


def inv_level_2d_mxu_ad(a, h, v, d, rec_lo, rec_hi, mode: str, out_dtype=None):
    """Differentiable inverse level in an MXU ``mode``; ``out_dtype`` as
    in :func:`inv_plan`."""
    return _InvLevel2DMxu.apply(a, h, v, d, rec_lo, rec_hi, mode, out_dtype)
