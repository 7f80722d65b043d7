"""Separable multi-level 3D DWT and SWT, forward and inverse, and the fused
threshold-in-inverse of the 3D TI-denoise step.

Counterpart of ``pdwt_tpu/core/separable3d.py``.  Coefficient layout:
``Coeffs3D(approx, details)`` with ``details[i]`` the 7 bands of level
i+1, ordered by the analysis channel index

    ch = 4*k_col + 2*k_row + k_dep          (k = 0 low-pass, 1 high-pass)

that is pywt's ``dwtn`` keys in axis order (depth, row, column),
:data:`DETAIL_KEYS_3D` = (daa, ada, dda, aad, dad, add, ddd); ``details[i][0]``
is high-pass along depth only.  Leading dimensions act as the batch.

No kernel of its own: each level runs a 2D level kernel over (rows,
columns) with depth as its batch, and the depth pass between them is one
matrix product (``core/depth_matmul.py``), as JAX composes it:

* decimated forward: the volume odd-extended on all three axes, kernel 1
  (``fwd_level_2d``) on (B*D, R, C), or in an MXU mode kernel 11 where
  ``kernels.mxu_route_2d`` accepts the level; then each of the four 2D
  subbands its own depth analysis (:func:`depth_split`);
* stationary forward: kernel 5, or under bf16 kernel 13 where
  ``kernels.mxu_route_swt_2d`` accepts the level, then the dilated depth
  analysis;
* exact inverse: the depth synthesis of the four (lo, hi) depth pairs
  first, then one kernel 2 (or 6) launch a level;
* inverse in an MXU mode where the route accepts the level, and
  :func:`iswt3d_denoise` in every tier: the depth-bit regrouping
  (:func:`inv_level_regrouped`), two 2D inverses a level (kernels 12 or 14,
  kernel 6 with its threshold in the exact denoise), then the depth
  synthesis of the pair.

The tiers follow the 2D transforms (``core/separable.py``): the MXU mode
comes from the dtype; under "bf16" the approximation chain is float32 and
the details bf16 (``daa``, a depth pass of the float32 A subband, is cast),
the 2D inverses write float32 and the inverse's last level casts to bf16;
``mixed`` runs the stationary transforms exact.  A route is decided by
shape before the launch; nothing falls back after one.

Boundary modes (``mode=`` on :func:`dwt3d` and :func:`idwt3d`, a string or
(depth, row, column) modes): anything but periodization on every axis runs
the conv passes with ``mode=`` (JAX's fma formulation), columns, rows,
then depth (the inverse depth, rows, columns), in the input's dtype, on
the card too.

``backend=`` and ``pad_fn=`` follow the 2D transforms
(``core/separable.py``, :func:`separable.auto_backend`): the kernel route
above for ``None`` or ``"pallas"``; ``"fma"``, ``"xla"`` and ``"gather"``
(and ``None`` with a ``pad_fn``) run the conv passes of that formulation
along columns, rows, then depth (the inverse depth, rows, columns), as JAX
does (``pdwt_tpu/core/separable3d.py:178-520``), and launch no kernel.

Every entry point takes ``precision=`` (:func:`precision.takes_precision`).
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels
from ..filters import Wavelet
from ..utils.profiling import spanned
from . import conv, modes
from .depth_matmul import depth_analysis_mm, depth_synthesis_mm
from .precision import takes_precision
from .separable import (BF16, F32, _dwt_conv, _idwt_conv, _swt_mxu_mode, auto_backend,
                        check_dtype, check_supported, kernel_route, mxu_mode,
                        thresholds_in_kernel)
from .shapes import level_sizes

#: pywt-style keys (axis order depth, row, column) of ``details[i][j]``
DETAIL_KEYS_3D = ("daa", "ada", "dda", "aad", "dad", "add", "ddd")


class Coeffs3D(NamedTuple):
    approx: torch.Tensor
    details: Tuple[Tuple[torch.Tensor, ...], ...]  # 7 bands a level

    @property
    def levels(self) -> int:
        return len(self.details)


def _flat3(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((-1,) + tuple(t.shape[-3:])).contiguous()


def _unflat(t: torch.Tensor, batch: Tuple[int, ...]) -> torch.Tensor:
    return t.reshape(batch + tuple(t.shape[1:]))


def _check_3d(x: torch.Tensor) -> None:
    if x.ndim < 3:
        raise ValueError(f"expected at least 3D input, got shape {tuple(x.shape)}")
    check_dtype(x)


# ---------------------------------------------------------------------------
# the two helpers the single-card and (later) sharded compositions share
# ---------------------------------------------------------------------------

def depth_split(res, wav: Wavelet, b: int, d: int, *, dilation: int = 1,
                decimate: bool = True, mxu=None, analysis: Callable = depth_analysis_mm):
    """The depth analysis of the four (B*D, r, c) subbands ``res`` of a 2D
    level (order a, h, v, d = 2*k_col + k_row), each its own pass
    ``analysis(x, filters, dilation=, decimate=)`` on (B, D, r, c) giving
    (B, 2, D', r, c).  Returns the 8 channels ch = 4*k_col + 2*k_row +
    k_dep, each (B, D', r, c).  Channel 1 (daa), a detail made from the A
    subband, is cast to bf16 under the "bf16" mode."""
    r, c = res[0].shape[-2:]
    dec = (wav.dec_lo, wav.dec_hi)
    pairs = [analysis(t.reshape(b, d, r, c), dec, dilation=dilation, decimate=decimate)
             for t in res]
    daa = pairs[0][:, 1]
    if mxu == "bf16":
        daa = daa.to(BF16)
    return (pairs[0][:, 0], daa, pairs[1][:, 0], pairs[1][:, 1], pairs[2][:, 0],
            pairs[2][:, 1], pairs[3][:, 0], pairs[3][:, 1])


def inv_level_regrouped(a: torch.Tensor, bands7: Sequence[torch.Tensor], inv2d: Callable,
                        wav: Wavelet, *, out_dep: int = 0, swt_level: int = 0,
                        synthesis: Callable = depth_synthesis_mm) -> torch.Tensor:
    """Invert one 3D level regrouped by the depth bit: the synthesis passes
    act on separate axes and commute, so the level is two 2D inverses, one
    for k_dep = 0 (A, ada, aad, add) and one for k_dep = 1 (daa, dda, dad,
    ddd), then the depth synthesis of the pair (dilated with the taps halved
    at ``swt_level`` > 0, else decimated to ``out_dep``).  ``a`` and
    ``bands7`` are (B, dd, mr, mc); ``inv2d(a2, h2, v2, d2)`` inverts one
    group of (B*dd, mr, mc) subbands to (B*dd, R, C); ``synthesis(bands,
    filters, out_len=, dilation=, decimated=)`` is the depth pass.
    Returns (B, D', R, C)."""
    b, dd = a.shape[:2]
    flat = lambda t: t.reshape((b * dd,) + tuple(t.shape[-2:])).contiguous()
    outs = []
    for grp in ((a, bands7[1], bands7[3], bands7[5]),            # k_dep = 0
                (bands7[0], bands7[2], bands7[4], bands7[6])):   # k_dep = 1
        y = inv2d(*(flat(t) for t in grp))
        outs.append(y.reshape((b, dd) + tuple(y.shape[-2:])))
    if not swt_level:
        return synthesis(outs, (wav.rec_lo, wav.rec_hi), out_len=out_dep)
    return synthesis(outs, (wav.rec_lo * 0.5, wav.rec_hi * 0.5), out_len=dd,
                     dilation=1 << (swt_level - 1), decimated=False)


def _depth_pairs(a, bands7):
    """The (lo, hi) depth pairs of the 8 channels: (A, daa), (ada, dda),
    (aad, dad), (add, ddd), which synthesize the 2D subbands a, h, v, d."""
    chans = [a, *bands7]
    return [chans[2 * k:2 * k + 2] for k in range(4)]


# ---------------------------------------------------------------------------
# decimated
# ---------------------------------------------------------------------------

def _fwd_level(a: torch.Tensor, wav: Wavelet, mxu):
    """One decimated level of (B, D, R, C): the 8 channels, each
    (B, D', R', C')."""
    lo, hi = wav.dec_lo, wav.dec_hi
    for ax in (-1, -2, -3):
        a = conv.odd_extend(a, ax)
    b, d, r, c = a.shape
    flat = a.reshape(b * d, r, c).contiguous()
    if mxu and kernels.mxu_route_2d(r // 2, c // 2, wav.hlen):
        res = kernels.fwd_level_2d_mxu_ad(flat, lo, hi, mxu)
    else:
        res = kernels.fwd_level_2d_ad(flat.float() if mxu else flat, lo, hi)
        if mxu == "bf16":
            res = (res[0],) + tuple(t.to(BF16) for t in res[1:])
    return depth_split(res, wav, b, d, mxu=mxu)


def _inv_level_exact(a, bands7, wav: Wavelet, drc, level: int = 0) -> torch.Tensor:
    """One exact inverse level: the depth synthesis of the four depth pairs
    (dilated, taps halved, at ``level`` > 0), then one 2D inverse kernel
    launch (kernel 2, or 6 at ``level``), sliced to ``drc``'s rows and
    columns.  Returns (B, D, R, C)."""
    lo, hi = wav.rec_lo, wav.rec_hi
    if level:
        kw = dict(out_len=a.shape[1], dilation=1 << (level - 1), decimated=False)
        rec = (lo * 0.5, hi * 0.5)
    else:
        kw, rec = dict(out_len=drc[0]), (lo, hi)
    t = [depth_synthesis_mm(p, rec, **kw) for p in _depth_pairs(a, bands7)]
    b, dd, mr, mc = t[0].shape
    flat = [u.reshape(b * dd, mr, mc) for u in t]
    if level:
        y = kernels.swt_inv_level_2d_ad(*flat, lo, hi, level)
    else:
        y = kernels.inv_level_2d_ad(*flat, lo, hi)[:, :drc[1], :drc[2]]
    return y.reshape((b, dd) + tuple(y.shape[-2:])).contiguous()


def _dwt3d_mode(x: torch.Tensor, wav: Wavelet, levels: int, per: Tuple[str, str, str],
                backend: Optional[str] = None, pad_fn=None, *, stationary: bool = False,
                keep_approx: bool = False):
    """The conv route of :func:`dwt3d` (and, ``stationary``, of
    :func:`swt3d`): the conv passes with ``mode=`` along columns, rows,
    then depth, in the input's dtype."""
    batch = tuple(x.shape[:-3])
    a, dets, apx = _dwt_conv(_flat3(x)[:, None], wav, levels, (-1, -2, -3),
                             (per[2], per[1], per[0]), stationary=stationary, backend=backend,
                             pad_fn=pad_fn, keep_approx=keep_approx)
    un = lambda t: _unflat(t[:, 0], batch)
    coeffs = Coeffs3D(un(a), tuple(tuple(un(t) for t in band) for band in dets))
    return (coeffs, tuple(un(t) for t in apx)) if keep_approx else coeffs


def _idwt3d_mode(coeffs: Coeffs3D, wav: Wavelet, shape, per: Tuple[str, str, str],
                 backend: Optional[str] = None, pad_fn=None, *, stationary: bool = False
                 ) -> torch.Tensor:
    """The conv route of :func:`idwt3d` (and, ``stationary``, of
    :func:`iswt3d`): depth, rows, then columns, each level to its pywt (or
    periodization) size."""
    batch = tuple(coeffs.approx.shape[:-3])
    sizes = None
    if not stationary:
        sizes = [level_sizes(n, coeffs.levels, wav.hlen, m) for n, m in zip(shape, per)]
    dets = [[_flat3(t)[:, None] for t in band] for band in coeffs.details]
    a = _idwt_conv(_flat3(coeffs.approx)[:, None], dets, wav, (-3, -2, -1), per, sizes,
                   stationary=stationary, backend=backend, pad_fn=pad_fn)
    return _unflat(a[:, 0], batch)


_PER3 = ("periodization",) * 3


@spanned("transform")
@takes_precision
def dwt3d(x: torch.Tensor, wav: Wavelet, levels: int, *, backend: Optional[str] = None,
          pad_fn=None, mode="periodization") -> Coeffs3D:
    """Multi-level separable 3D DWT over the trailing three axes: per level
    one 2D level kernel with depth as its batch, then the depth pass
    (module docstring).  ``mode``: the boundary extension, a string or
    (depth, row, column) modes; anything but periodization takes the conv
    passes; ``backend``, ``pad_fn``: the route (module docstring)."""
    _check_3d(x)
    per = modes.per_axis(mode, 3)
    if per != _PER3:
        return _dwt3d_mode(x, wav, levels, per, auto_backend(backend, pad_fn, mode), pad_fn)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _dwt3d_mode(x, wav, levels, per, backend, pad_fn)
    check_supported(x)
    batch = tuple(x.shape[:-3])
    mxu = mxu_mode(x.dtype)
    a, details = _flat3(x), []
    for _ in range(levels):
        bands = _fwd_level(a, wav, mxu)
        a = bands[0]
        details.append(tuple(_unflat(t, batch) for t in bands[1:]))
    return Coeffs3D(_unflat(a, batch), tuple(details))


@spanned("transform")
@takes_precision
def idwt3d(coeffs: Coeffs3D, wav: Wavelet, shape: Tuple[int, int, int], *,
           backend: Optional[str] = None, pad_fn=None, mode="periodization") -> torch.Tensor:
    """Inverse of :func:`dwt3d`; ``shape`` = (Nd, Nr, Nc) of the volume,
    ``mode`` the forward's.  An exact level runs the depth synthesis, then
    kernel 2; a level the MXU route accepts runs two kernel-12 launches
    (the depth-bit regrouping), then the depth synthesis.  ``backend``,
    ``pad_fn``: the route (module docstring)."""
    _check_3d(coeffs.approx)
    per = modes.per_axis(mode, 3)
    if per != _PER3:
        return _idwt3d_mode(coeffs, wav, shape, per, auto_backend(backend, pad_fn, mode),
                            pad_fn)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _idwt3d_mode(coeffs, wav, shape, per, backend, pad_fn)
    check_supported(coeffs.approx)
    levels = coeffs.levels
    deps, rows, cols = (level_sizes(n, levels) for n in shape)
    lo, hi = wav.rec_lo, wav.rec_hi
    batch = tuple(coeffs.approx.shape[:-3])
    mxu = mxu_mode(coeffs.details[-1][0].dtype if levels else coeffs.approx.dtype)
    a = _flat3(coeffs.approx)
    a = a.float() if mxu == "bf16" else a
    for i in range(levels - 1, -1, -1):
        out_dt = (BF16 if mxu == "bf16" and i == 0 else F32) if mxu else None
        drc = (deps[i], rows[i], cols[i])
        bands = [_flat3(t) for t in coeffs.details[i]]
        if mxu and kernels.mxu_route_2d(a.shape[-2], a.shape[-1], wav.hlen):
            def inv2d(a2, h2, v2, d2):
                y = kernels.inv_level_2d_mxu_ad(a2, h2, v2, d2, lo, hi, mxu, F32)
                return y[:, :drc[1], :drc[2]]
            a = inv_level_regrouped(a, bands, inv2d, wav, out_dep=drc[0])
        else:
            if mxu:
                a, bands = a.float(), [t.float() for t in bands]
            a = _inv_level_exact(a, bands, wav, drc)
        a = (a if out_dt is None else a.to(out_dt)).contiguous()
    return _unflat(a, batch)


# ---------------------------------------------------------------------------
# stationary (a-trous)
# ---------------------------------------------------------------------------

@spanned("transform")
@takes_precision
def swt3d(x: torch.Tensor, wav: Wavelet, levels: int, *, backend: Optional[str] = None,
          pad_fn=None, keep_approx: bool = False):
    """Stationary (a-trous) 3D transform over the trailing three axes: level
    L filters with taps ``2^(L-1)`` apart, no subsampling; one 2D a-trous
    kernel launch a level (kernel 5, or 13 in bf16 where the route accepts
    the level), then the dilated depth pass.  ``keep_approx=True`` also
    returns the approximations ``(A_1, ..., A_levels)``.  ``backend``,
    ``pad_fn``: the route (module docstring)."""
    _check_3d(x)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _dwt3d_mode(x, wav, levels, _PER3, backend, pad_fn, stationary=True,
                           keep_approx=keep_approx)
    check_supported(x)
    batch = tuple(x.shape[:-3])
    mxu = _swt_mxu_mode(x.dtype)
    lo, hi = wav.dec_lo, wav.dec_hi
    a = _flat3(x)
    details: List[Tuple[torch.Tensor, ...]] = []
    approxs = []
    for lvl in range(1, levels + 1):
        b, d, r, c = a.shape
        flat = a.reshape(b * d, r, c)
        if mxu and kernels.mxu_route_swt_2d(r, c, wav.hlen, lvl):
            res = kernels.swt_fwd_level_2d_mxu_ad(flat, lo, hi, lvl, mxu)
        else:
            res = kernels.swt_fwd_level_2d_ad(flat.float() if mxu else flat, lo, hi, lvl)
            if mxu:
                res = (res[0],) + tuple(t.to(BF16) for t in res[1:])
        bands = depth_split(res, wav, b, d, dilation=1 << (lvl - 1), decimate=False, mxu=mxu)
        a = bands[0].contiguous()
        details.append(tuple(_unflat(t, batch) for t in bands[1:]))
        if keep_approx:
            approxs.append(_unflat(a, batch))
    coeffs = Coeffs3D(_unflat(a, batch), tuple(details))
    return (coeffs, tuple(approxs)) if keep_approx else coeffs


def _iswt3d_levels(coeffs: Coeffs3D, wav: Wavelet, level_fn, a_fn=None) -> torch.Tensor:
    """Invert a 3D SWT deepest level first: ``level_fn(a, bands7, level,
    mxu)`` returns the float32 (or float64) level output of (B, D, R, C)
    bands; in bf16 the last level is cast to bf16.  ``a_fn`` maps the
    approximation first."""
    batch = tuple(coeffs.approx.shape[:-3])
    mxu = _swt_mxu_mode(coeffs.details[-1][0].dtype if coeffs.levels
                        else coeffs.approx.dtype)
    a = _flat3(coeffs.approx)
    a = a.float() if mxu == "bf16" else a
    if a_fn is not None:
        a = a_fn(a)
    for i in range(coeffs.levels - 1, -1, -1):
        a = level_fn(a, [_flat3(t) for t in coeffs.details[i]], i + 1, mxu)
        if mxu:
            a = a.to(BF16 if i == 0 else F32)
    return _unflat(a.contiguous(), batch)


@spanned("transform")
@takes_precision
def iswt3d(coeffs: Coeffs3D, wav: Wavelet, *, backend: Optional[str] = None,
           pad_fn=None) -> torch.Tensor:
    """Inverse of :func:`swt3d`.  Each separable synthesis pass halves the
    taps (three passes give the 1/8 that averages the 3D redundancy).  An
    exact level runs the depth synthesis, then kernel 6; a bf16 level the
    route accepts runs two kernel-14 launches, then the depth synthesis.
    ``backend``, ``pad_fn``: the route (module docstring)."""
    _check_3d(coeffs.approx)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _idwt3d_mode(coeffs, wav, None, _PER3, backend, pad_fn, stationary=True)
    check_supported(coeffs.approx)
    lo, hi = wav.rec_lo, wav.rec_hi

    def level(a, bands, lvl, mxu):
        r, c = a.shape[-2:]
        if mxu and kernels.mxu_route_swt_2d(r, c, wav.hlen, lvl):
            inv2d = lambda *g: kernels.swt_inv_level_2d_mxu_ad(*g, lo, hi, lvl, mxu, F32)
            return inv_level_regrouped(a, bands, inv2d, wav, swt_level=lvl)
        if mxu:
            a, bands = a.float(), [t.float() for t in bands]
        return _inv_level_exact(a, bands, wav, None, level=lvl)

    return _iswt3d_levels(coeffs, wav, level)


@spanned("transform")
@takes_precision
def iswt3d_denoise(coeffs: Coeffs3D, wav: Wavelet, beta, *, mode: str = "soft",
                   normalize: bool = False, do_thresh_appcoeffs: bool = False,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Threshold the details and invert the 3D SWT: the same values as
    ``<mode>_threshold`` followed by :func:`iswt3d`.  Every level inverts by
    the depth-bit regrouping, two 2D inverses whose kernels threshold their
    (h, v, d) inputs as they read them (kernel 6, or 14 in bf16 where the
    route accepts the level); the seventh band, daa, rides the k_dep = 1
    group's approximation slot, which the kernels leave alone, so it is
    thresholded first.  ``mode`` is soft, hard or garrote; a scalar ``beta``
    (a number or a one-element tensor) is divided by sqrt(2)^(i+1) at level
    i+1 under ``normalize``; a per-level (per-band) sequence goes through
    the threshold ops and :func:`iswt3d`, and so does every ``backend`` but
    the kernel route (JAX's rule)."""
    from ..ops.threshold import THR_ELEM, THRESHOLD_OPS, _app_beta

    if mode not in THR_ELEM:
        raise ValueError(f"the fused denoise takes {sorted(THR_ELEM)}, got {mode!r}")
    backend = auto_backend(backend, None)
    if not thresholds_in_kernel(beta, backend):
        return iswt3d(THRESHOLD_OPS[mode](coeffs, beta, normalize=normalize,
                                          do_thresh_appcoeffs=do_thresh_appcoeffs), wav,
                      backend=backend)
    _check_3d(coeffs.approx)
    check_supported(coeffs.approx)
    thr = THR_ELEM[mode]
    lo, hi = wav.rec_lo, wav.rec_hi

    def level(a, bands, lvl, mxu):
        bi = beta / math.sqrt(2.0) ** lvl if normalize else beta
        r, c = a.shape[-2:]
        routed = mxu and kernels.mxu_route_swt_2d(r, c, wav.hlen, lvl)

        def inv2d(*g):
            if routed:
                return kernels.swt_inv_level_2d_mxu_denoise_ad(*g, bi, lo, hi, lvl, mxu, mode,
                                                               F32)
            if mxu:
                g = [t.float() for t in g]
            return kernels.swt_inv_level_2d_denoise_ad(*g, bi, lo, hi, lvl, mode)

        return inv_level_regrouped(a, [thr(bands[0], bi)] + bands[1:], inv2d, wav,
                                   swt_level=lvl)

    app = None
    if do_thresh_appcoeffs:
        app = lambda a: thr(a, _app_beta(beta, coeffs.levels, normalize))
    return _iswt3d_levels(coeffs, wav, level, app)
