"""Fused separable DWT level kernels: wrappers, plain versions, gradients.

Counterpart of ``pdwt_tpu/kernels/separable_pallas.py``.  Four CUDA
kernels (``csrc/separable.cu``) carry the 2D periodization main path:

=================  ==========================================  =======================
wrapper            computes                                    plain version
=================  ==========================================  =======================
``fwd_level_2d``   one analysis level, both passes fused       ``fwd_level_2d_ref``
``inv_level_2d``   one synthesis level, both passes fused      ``inv_level_2d_ref``
``fwd_tail_2d``    all remaining analysis levels, one launch   ``fwd_tail_2d_ref``
``inv_tail_2d``    the k deepest synthesis levels, one launch  ``inv_tail_2d_ref``
=================  ==========================================  =======================

A wrapper given a CPU tensor returns its plain version, built on
``core/conv.py``; given a CUDA tensor it launches its kernel or raises.
Each launch adds one to ``LAUNCHES[<wrapper name>]``.

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
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core import conv

#: Longest filter the CUDA kernels take (PDWT_MAX_HLEN in separable.cu).
MAX_HLEN = 128
#: Most levels one tail launch fuses (PDWT_MAX_TAIL_LEVELS).
MAX_TAIL_LEVELS = 16
#: Dynamic shared memory one block may use on Hopper (227 KiB).
SMEM_PER_BLOCK = 232448

#: Kernel launches per wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"fwd_level_2d": 0, "inv_level_2d": 0,
                            "fwd_tail_2d": 0, "inv_tail_2d": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _is_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"the CUDA kernels take float32, got {t.dtype}; other dtypes "
                "come with the precision tiers (ROADMAP queue 1, item 9)")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.dim() != 3 or t.numel() == 0:
            raise ValueError(f"expected a non-empty (B, R, C) tensor, got {tuple(t.shape)}")
    return False


def _taps(f) -> np.ndarray:
    """Correlation-order float32 taps (kept alive by the caller)."""
    f = np.asarray(f, dtype=np.float64)
    if not 2 <= len(f) <= MAX_HLEN:
        raise ValueError(f"the CUDA kernels take filters of 2..{MAX_HLEN} taps, got {len(f)}")
    return np.ascontiguousarray(f[::-1], dtype=np.float32)


def _geo(hlen: int) -> np.ndarray:
    g = conv.poly_geometry(hlen)
    return np.array([*g.p, *g.o, *g.nb, g.lo, g.hi], dtype=np.int32)


def _ptr(a) -> ctypes.c_void_p:
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    return a.ctypes.data_as(ctypes.c_void_p)


def _launch(name: str, device: torch.device, args) -> None:
    from . import _build

    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "pdwt_" + name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.pdwt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fwd_level_2d(x: torch.Tensor, dec_lo, dec_hi):
    """One analysis level on an even-sized (B, R, C) image -> (a, h, v, d),
    each (B, R/2, C/2)."""
    if _is_cpu(x):
        return fwd_level_2d_ref(x, dec_lo, dec_hi)
    B, R, C = x.shape
    if R % 2 or C % 2:
        raise ValueError(f"fwd_level_2d takes even sizes, got {(R, C)}")
    tl, th = _taps(dec_lo), _taps(dec_hi)
    outs = [torch.empty((B, R // 2, C // 2), device=x.device, dtype=x.dtype)
            for _ in range(4)]
    _launch("fwd_level_2d", x.device,
            [_ptr(x), *map(_ptr, outs), B, R, C, _ptr(tl), _ptr(th), len(tl),
             conv.fwd_center(len(tl))])
    return tuple(outs)


def inv_level_2d(a, h, v, d, rec_lo, rec_hi) -> torch.Tensor:
    """One synthesis level: (B, Mr, Mc) subbands -> (B, 2Mr, 2Mc)."""
    if _is_cpu(a, h, v, d):
        return inv_level_2d_ref(a, h, v, d, rec_lo, rec_hi)
    if not a.shape == h.shape == v.shape == d.shape:
        raise ValueError("the four subbands must have one shape")
    B, mr, mc = a.shape
    tl, th = _taps(rec_lo), _taps(rec_hi)
    geo = _geo(len(tl))
    out = torch.empty((B, 2 * mr, 2 * mc), device=a.device, dtype=a.dtype)
    _launch("inv_level_2d", a.device,
            [*map(_ptr, (a, h, v, d, out)), B, mr, mc, _ptr(tl), _ptr(th),
             len(tl), _ptr(geo)])
    return out


def fwd_tail_2d(x: torch.Tensor, dec_lo, dec_hi, levels: int):
    """All ``levels`` remaining analysis levels of a (B, R, C) image in one
    launch -> (a, [(h, v, d) of level 1, level 2, ...])."""
    if _is_cpu(x):
        return fwd_tail_2d_ref(x, dec_lo, dec_hi, levels)
    B, R, C = x.shape
    if not tail_supported((R, C), len(dec_lo), levels):
        raise ValueError(f"fwd_tail_2d: {levels} levels of {(R, C)} with "
                         f"{len(dec_lo)} taps is not tail_supported")
    tl, th = _taps(dec_lo), _taps(dec_hi)
    a = torch.empty((B, R >> levels, C >> levels), device=x.device, dtype=x.dtype)
    dets: List[Bands] = []
    for lvl in range(1, levels + 1):
        dets.append(tuple(torch.empty((B, R >> lvl, C >> lvl), device=x.device,
                                      dtype=x.dtype) for _ in range(3)))
    ptrs = (ctypes.c_void_p * (3 * levels))(
        *[t.data_ptr() for band in dets for t in band])
    _launch("fwd_tail_2d", x.device,
            [_ptr(x), _ptr(a), ptrs, B, R, C, levels, _ptr(tl), _ptr(th),
             len(tl), conv.fwd_center(len(tl))])
    return a, dets


def inv_tail_2d(a: torch.Tensor, details: Sequence[Bands], rec_lo, rec_hi):
    """Inverse of :func:`fwd_tail_2d`: ``a`` (B, m, m') and ``details``
    (deepest level first) -> (B, m << k, m' << k), k = len(details)."""
    flat = [t for band in details for t in band]
    if _is_cpu(a, *flat):
        return inv_tail_2d_ref(a, details, rec_lo, rec_hi)
    levels = len(details)
    B, mr, mc = a.shape
    for lvl, band in enumerate(details):
        want = (B, mr << lvl, mc << lvl)
        if any(tuple(t.shape) != want for t in band):
            raise ValueError(f"inv_tail_2d: level {lvl} (deepest first) must "
                             f"have shape {want}")
    if not tail_supported((mr << levels, mc << levels), len(rec_lo), levels):
        raise ValueError(f"inv_tail_2d: {levels} levels of {(mr, mc)} with "
                         f"{len(rec_lo)} taps is not tail_supported")
    tl, th = _taps(rec_lo), _taps(rec_hi)
    geo = _geo(len(tl))
    out = torch.empty((B, mr << levels, mc << levels), device=a.device, dtype=a.dtype)
    ptrs = (ctypes.c_void_p * (3 * levels))(*[t.data_ptr() for t in flat])
    _launch("inv_tail_2d", a.device,
            [_ptr(a), ptrs, _ptr(out), B, mr, mc, levels, _ptr(tl), _ptr(th),
             len(tl), _ptr(geo)])
    return out


# ---------------------------------------------------------------------------
# autograd: each backward is the paired kernel with reversed taps
# ---------------------------------------------------------------------------

def _rev(f) -> np.ndarray:
    return np.asarray(f, dtype=np.float64)[::-1].copy()


def _c(ts):
    return [t.contiguous() for t in ts]


class _FwdLevel2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dec_lo, dec_hi):
        ctx.filters = (dec_lo, dec_hi)
        return fwd_level_2d(x, dec_lo, dec_hi)

    @staticmethod
    def backward(ctx, ga, gh, gv, gd):
        lo, hi = ctx.filters
        return inv_level_2d(*_c((ga, gh, gv, gd)), _rev(lo), _rev(hi)), None, None


class _InvLevel2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, h, v, d, rec_lo, rec_hi):
        ctx.filters = (rec_lo, rec_hi)
        return inv_level_2d(a, h, v, d, rec_lo, rec_hi)

    @staticmethod
    def backward(ctx, gy):
        lo, hi = ctx.filters
        return (*fwd_level_2d(gy.contiguous(), _rev(lo), _rev(hi)), None, None)


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
        y = inv_tail_2d(ga.contiguous(), bands[::-1], _rev(lo), _rev(hi))
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
        ga, gdets = fwd_tail_2d(gy.contiguous(), _rev(lo), _rev(hi), levels)
        flat = [t for band in gdets[::-1] for t in band]  # deepest first
        return (None, None, ga, *flat)


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
