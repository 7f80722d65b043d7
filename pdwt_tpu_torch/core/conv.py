"""Filtering primitives: the conv passes in JAX's three formulations.

Counterpart of ``pdwt_tpu/core/conv.py``.  ``backend=`` on
:func:`analysis_pass` and :func:`synthesis_pass` picks one of JAX's three
independent formulations of the same index spec:

* ``"fma"``: slice-FMA, one scaled contiguous slice a tap (decimation an
  even/odd split, the decimated synthesis stuff-free polyphase), the
  port's plain path and the default on every device;
* ``"xla"``: ``torch.nn.functional.conv1d/2d/3d`` with one group a
  channel, a stride and a dilation, laid out as JAX's
  ``lax.conv_general_dilated`` call (``_kernel_nd``/``_conv_nchw``), the
  synthesis on the zero-stuffed input; float32 runs in IEEE FP32 (no
  TF32) in both directions, as JAX runs ``Precision.HIGHEST``;
* ``"gather"``: a window gather (``index_select``) and one contraction
  with the taps (``tensordot`` at IEEE FP32), the synthesis taking the
  ``(k, k)`` diagonal of the band-by-filter products.

bfloat16 data is summed in float32 and rounded once a pass in all three,
as JAX's ``preferred_element_type`` does.  ``backend=None`` takes
:func:`get_default_backend`: an override (:func:`set_default_backend`,
or the ``PDWT_TPU_BACKEND`` environment variable read at import) when it
names one of the three, else ``"fma"``.  JAX picks ``"xla"`` off a TPU;
the port takes JAX's TPU route on every device.

The index spec of periodization, the default, is the same in all three:

Forward analysis::

    c  = fwd_center(hlen)
    xe = x extended by repeating the last element when N is odd
    out[n] = sum_j filt[hlen-1-j] * xe[(2n - c + j) mod Ne],  n in [0, Ne/2)

Inverse synthesis, stuff-free polyphase (see :func:`poly_geometry`)::

    out[2m + q] = sum_k sum_b rev_k[p_q + 2b] * x_k[(m + o_q + b) mod M]

with ``rev_k`` the reversed synthesis filter of band k.  That is the
correlation of the zero-stuffed coefficients with the reversed synthesis
filter at shift ``inv_shift(hlen)``, computed without the zeros.

Stationary (a-trous) passes, ``decimate=False`` / ``decimated=False``:
stride 1, taps dilated by ``f = 2^(level-1)``::

    analysis   out[n] = sum_j filt[hlen-1-j] * x[(n - c*f + j*f) mod N]
    synthesis  out[n] = sum_k sum_j rev_k[j] * x_k[(n - s*f + j*f) mod N]

with ``c = fwd_center(hlen)`` and ``s = swt_inv_center(hlen)``; the caller
folds the synthesis's 1/2 per pass into the filters.

The other boundary modes (``core/modes.py``, decimated passes only) follow
pywt: the analysis is a valid decimating correlation over the signal
extended by (hlen - 2, hlen - 1) samples, ``floor((N + hlen - 1) / 2)``
outputs; the synthesis is the polyphase form at shift 1 over zero-padded
coefficients, ``2M - hlen + 2`` outputs (even ``hlen`` only), sliced to the
stored length.  bfloat16 passes of a mode sum in float32 and round once
per pass, as JAX's fma formulation does.

Passes work on (B, C, H, W) tensors of float32 or float64.  The CUDA
kernels (``pdwt_tpu_torch/kernels``) read their offsets from
:func:`fwd_center` and :func:`poly_geometry`, so the index arithmetic is
defined here once.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import modes

BACKENDS = ("fma", "xla", "gather")
#: the override of ``backend=None``: one of :data:`BACKENDS`, ``"pallas"``
#: (the transforms' kernel route; the passes map it to ``"fma"``) or None
_default_backend: Optional[str] = os.environ.get("PDWT_TPU_BACKEND") or None


def set_default_backend(name: Optional[str]) -> None:
    """Set (or with None clear) the override that ``backend=None``
    resolves to, here and in the transforms (``core/separable.py``)."""
    global _default_backend
    if name is not None and name not in BACKENDS + ("pallas",):
        raise ValueError(f"unknown backend {name!r}; expected one of {BACKENDS + ('pallas',)}")
    _default_backend = name


def get_default_backend() -> str:
    """The formulation of a pass called with ``backend=None``: the override
    when it names a formulation, else ``"fma"`` (a ``"pallas"`` override
    applies to the transforms only; the passes take ``"fma"``, the
    formulation JAX's kernels fall back to)."""
    if _default_backend in BACKENDS:
        return _default_backend
    return "fma"


def check_backend(backend: Optional[str]) -> str:
    """``backend`` resolved for a pass; raises on an unknown name."""
    backend = backend or get_default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def fwd_center(hlen: int) -> int:
    """Analysis center tap."""
    return hlen // 2 if hlen % 2 else hlen // 2 - 1


def inv_shift(hlen: int) -> int:
    """Synthesis shift in the upsampled domain."""
    h2 = hlen // 2
    c2 = h2 // 2
    return 2 * c2 + 1 if h2 % 2 else 2 * c2


def swt_inv_center(hlen: int) -> int:
    """Stationary synthesis center (before dilation)."""
    return hlen // 2


class PolyGeometry(NamedTuple):
    """Offsets of the stuff-free synthesis.  Output parity q uses the
    reversed taps ``p[q], p[q] + 2, ...`` (``nb[q]`` of them) on
    coefficients ``m + o[q] + b``; ``lo``/``hi`` are the periodic halo
    widths this needs below and above a coefficient window."""

    p: Tuple[int, int]
    o: Tuple[int, int]
    nb: Tuple[int, int]
    lo: int
    hi: int


def poly_geometry(hlen: int, s: Optional[int] = None) -> PolyGeometry:
    """The offsets of the synthesis at shift ``s`` (``inv_shift(hlen)``,
    periodization's, by default; pywt's modes take 1)."""
    s = inv_shift(hlen) if s is None else s
    p = (s % 2, 1 - s % 2)
    o = (-(s // 2), (1 - s + (1 - s % 2)) // 2)
    nb = tuple(len(range(p[q], hlen, 2)) for q in (0, 1))
    lo = max(0, -min(o))
    hi = max(0, max(o[q] + nb[q] - 1 for q in (0, 1)))
    return PolyGeometry(p, o, nb, lo, hi)


def _sl(x: torch.Tensor, ax: int, start: int, stop: int, step: int = 1):
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(start, stop, step)
    return x[tuple(idx)]


def odd_extend(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Repeat the last element when the size along ``axis`` is odd."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if n % 2 == 0:
        return x
    return torch.cat([x, _sl(x, ax, n - 1, n)], dim=ax)


def wrap_pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Periodic padding, also for pad widths larger than the axis."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if lo == 0 and hi == 0:
        return x
    parts = []
    if lo:
        full, rem = divmod(lo, n)
        if rem:
            parts.append(_sl(x, ax, n - rem, n))
        parts.extend([x] * full)
    parts.append(x)
    if hi:
        full, rem = divmod(hi, n)
        parts.extend([x] * full)
        if rem:
            parts.append(_sl(x, ax, 0, rem))
    return torch.cat(parts, dim=ax)


def zero_stuff(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Interleave zeros along ``axis``: [a0, a1, ...] -> [a0, 0, a1, 0, ...]."""
    ax = axis % x.ndim
    y = torch.stack([x, torch.zeros_like(x)], dim=ax + 1)
    shape = list(x.shape)
    shape[ax] *= 2
    return y.reshape(shape)


def _fma_analysis(xp: torch.Tensor, taps: np.ndarray, ax: int, *,
                  decimate: bool = True, dilation: int = 1) -> torch.Tensor:
    """Correlate padded ``xp`` (B, C, H, W) with every row of ``taps``
    (K, hlen, already reversed) along ``ax``: decimating by 2 through an
    even/odd split, or at stride 1 with the taps ``dilation`` apart.
    Returns (B, C*K, ...)."""
    k, hlen = taps.shape
    n_pad = xp.shape[ax]
    if decimate:
        n_out = (n_pad - hlen) // 2 + 1
        even = _sl(xp, ax, 0, n_pad, 2)
        odd = _sl(xp, ax, 1, n_pad, 2)
        term = lambda j: _sl(even if j % 2 == 0 else odd, ax, j // 2, j // 2 + n_out)
    else:
        n_out = n_pad - (hlen - 1) * dilation
        term = lambda j: _sl(xp, ax, j * dilation, j * dilation + n_out)
    outs = []
    for kk in range(k):
        acc = None
        for j in range(hlen):
            t = float(taps[kk, j]) * term(j)
            acc = t if acc is None else acc + t
        outs.append(acc)
    out = torch.stack(outs, dim=2)  # (B, C, K, ...)
    b, c = out.shape[0], out.shape[1]
    return out.reshape((b, c * k) + tuple(out.shape[3:]))


def _fma_synthesis_poly(x: torch.Tensor, taps: np.ndarray, ax: int, pad_fn=wrap_pad,
                        s: Optional[int] = None) -> torch.Tensor:
    """Stuff-free decimated synthesis at shift ``s`` (see
    :func:`poly_geometry`) over ``x`` padded by ``pad_fn``: input
    (B, C*K, ...), where each group of K channels is combined into one
    output channel; each output parity is a half-length FIR over the
    coefficients and the two parities interleave."""
    k, hlen = taps.shape
    m = x.shape[ax]
    g = poly_geometry(hlen, s)
    ap = pad_fn(x, ax, g.lo, g.hi)
    outs = []
    for q in (0, 1):
        acc = None
        for kk in range(k):
            src = ap[:, kk::k]
            for b, j in enumerate(range(g.p[q], hlen, 2)):
                start = g.lo + g.o[q] + b
                term = float(taps[kk, j]) * _sl(src, ax, start, start + m)
                acc = term if acc is None else acc + term
        outs.append(acc)
    y = torch.stack(outs, dim=ax + 1)
    shape = list(outs[0].shape)
    shape[ax] = 2 * m
    return y.reshape(shape)


def _fma_synthesis(up: torch.Tensor, taps: np.ndarray, ax: int, dilation: int
                   ) -> torch.Tensor:
    """Stationary synthesis of padded ``up`` (B, C*K, ...): output channel c
    sums the K dilated correlations of its group."""
    k, hlen = taps.shape
    n_out = up.shape[ax] - (hlen - 1) * dilation
    acc = None
    for kk in range(k):
        src = up[:, kk::k]
        for j in range(hlen):
            t = float(taps[kk, j]) * _sl(src, ax, j * dilation, j * dilation + n_out)
            acc = t if acc is None else acc + t
    return acc


def _check(x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"expected float32 or float64 (or bfloat16), got {x.dtype}")


def _acc(x: torch.Tensor) -> torch.Tensor:
    """The pass's working dtype: float32 for bfloat16 data."""
    return x.float() if x.dtype == torch.bfloat16 else x


# ---------------------------------------------------------------------------
# the "xla" and "gather" formulations (JAX's ``_conv_nchw``, ``_gather_corr``)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def ieee_fp32():
    """float32 convolutions and products in IEEE FP32 (no TF32) while the
    block runs; the caller's settings come back after it."""
    cd = torch.backends.cudnn
    new_api = getattr(getattr(cd, "conv", None), "fp32_precision", None) is not None
    prev_conv = cd.conv.fp32_precision if new_api else cd.allow_tf32
    prev_mm = torch.get_float32_matmul_precision()
    if new_api:
        cd.conv.fp32_precision = "ieee"
    else:
        cd.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_mm)
        if new_api:
            cd.conv.fp32_precision = prev_conv
        else:
            cd.allow_tf32 = prev_conv


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}
_CONV_INPUT = {1: torch.nn.grad.conv1d_input, 2: torch.nn.grad.conv2d_input,
               3: torch.nn.grad.conv3d_input}


class _IeeeConv(torch.autograd.Function):
    """A grouped valid convolution with constant taps, in IEEE FP32 both
    ways (the backward is the input gradient under the same setting)."""

    @staticmethod
    def forward(ctx, x, kern, stride, dilation, groups):
        ctx.save_for_backward(kern)
        ctx.conf = (tuple(x.shape), stride, dilation, groups)
        with ieee_fp32():
            return _CONV[x.ndim - 2](x, kern, stride=stride, dilation=dilation, groups=groups)

    @staticmethod
    def backward(ctx, g):
        (kern,) = ctx.saved_tensors
        shape, stride, dilation, groups = ctx.conf
        with ieee_fp32():
            gx = _CONV_INPUT[len(shape) - 2](shape, kern, g.contiguous(), stride=stride,
                                             dilation=dilation, groups=groups)
        return gx, None, None, None, None


def _conv_nchw(x: torch.Tensor, kern: np.ndarray, ax: int, stride: int, dilation: int,
               groups: int) -> torch.Tensor:
    """JAX's ``_conv_nchw``: the valid correlation of (B, C, *spatial) ``x``
    with ``kern`` (O, I, hlen), its taps along spatial axis ``ax``."""
    sd = x.ndim - 2
    shape = [kern.shape[0], kern.shape[1]] + [1] * sd
    shape[ax] = kern.shape[2]
    k = torch.from_numpy(np.array(kern).reshape(shape)).to(x.device, x.dtype)
    strides, dils = [1] * sd, [1] * sd
    strides[ax - 2], dils[ax - 2] = stride, dilation
    return _IeeeConv.apply(x, k, tuple(strides), tuple(dils), groups)


def _xla_analysis(xp: torch.Tensor, taps: np.ndarray, ax: int, *, decimate: bool,
                  dilation: int) -> torch.Tensor:
    """The "xla" analysis: one group a channel, its K filters the group's
    outputs c*K + k."""
    k, hlen = taps.shape
    ch = xp.shape[1]
    kern = np.broadcast_to(taps[None], (ch, k, hlen)).reshape(ch * k, 1, hlen)
    return _conv_nchw(xp, kern, ax, 2 if decimate else 1, dilation, ch)


def _xla_synthesis(up: torch.Tensor, taps: np.ndarray, ax: int, dilation: int) -> torch.Tensor:
    """The "xla" synthesis of padded (zero-stuffed) ``up`` (B, C*K, ...):
    group c's K channels correlated with the K filters and summed."""
    k, hlen = taps.shape
    ch = up.shape[1] // k
    kern = np.broadcast_to(taps[None], (ch, k, hlen))
    return _conv_nchw(up, kern, ax, 1, dilation, ch)


def _gather_corr(xp: torch.Tensor, taps: np.ndarray, ax: int, *, stride: int,
                 dilation: int) -> torch.Tensor:
    """JAX's ``_gather_corr``: the valid correlation of every channel of
    ``xp`` with every row of ``taps`` (K, hlen) as a window gather and one
    contraction.  Returns (B, C*K, ...)."""
    k, hlen = taps.shape
    n_out = (xp.shape[ax] - (hlen - 1) * dilation - 1) // stride + 1
    idx = stride * np.arange(n_out)[:, None] + dilation * np.arange(hlen)[None, :]
    win = xp.index_select(ax, torch.from_numpy(idx.reshape(-1)).to(xp.device))
    win = win.reshape(tuple(xp.shape[:ax]) + (n_out, hlen) + tuple(xp.shape[ax + 1:]))
    t = torch.from_numpy(np.array(taps.T)).to(xp.device, xp.dtype)
    with ieee_fp32():
        out = torch.tensordot(win, t, dims=([ax + 1], [0]))
    out = out.movedim(-1, 2)  # (B, C, K, ...)
    return out.reshape((out.shape[0], out.shape[1] * k) + tuple(out.shape[3:]))


def _gather_synthesis(up: torch.Tensor, taps: np.ndarray, ax: int, dilation: int
                      ) -> torch.Tensor:
    """The "gather" synthesis: every band with every filter, then the
    (k, k) diagonal summed within each group of K channels."""
    k = taps.shape[0]
    corr = _gather_corr(up, taps, ax, stride=1, dilation=dilation)
    b, ch = corr.shape[0], up.shape[1] // k
    corr = corr.reshape((b, ch, k, k) + tuple(corr.shape[2:]))
    return corr.diagonal(dim1=2, dim2=3).sum(-1)


def _analysis(xp: torch.Tensor, taps: np.ndarray, ax: int, backend: str, *,
              decimate: bool = True, dilation: int = 1) -> torch.Tensor:
    """The valid analysis of padded ``xp`` in one formulation."""
    if backend == "fma":
        return _fma_analysis(xp, taps, ax, decimate=decimate, dilation=dilation)
    if backend == "xla":
        return _xla_analysis(xp, taps, ax, decimate=decimate, dilation=dilation)
    return _gather_corr(xp, taps, ax, stride=2 if decimate else 1, dilation=dilation)


def _synthesis(up: torch.Tensor, taps: np.ndarray, ax: int, backend: str,
               dilation: int = 1) -> torch.Tensor:
    """The valid synthesis of padded (zero-stuffed) ``up`` in "xla" or
    "gather", or "fma" over the stuffed input (the stationary pass)."""
    if backend == "fma":
        return _fma_synthesis(up, taps, ax, dilation)
    if backend == "xla":
        return _xla_synthesis(up, taps, ax, dilation)
    return _gather_synthesis(up, taps, ax, dilation)


def analysis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int, *,
                  dilation: int = 1, decimate: bool = True, backend: Optional[str] = None,
                  pad_fn=None, mode: str = "periodization") -> torch.Tensor:
    """Filter every channel of ``x`` (B, C, H, W) with each 1D filter
    along ``axis``: decimated by 2, or stationary with the taps
    ``dilation`` apart (``decimate=False``).  Returns (B, C*K, H', W')
    with output channel c*K + k = filter k applied to input channel c.
    ``filters`` are forward-convention taps (e.g. ``dec_lo``); the reversal
    for correlation happens here.  ``backend``: the formulation (module
    docstring).  ``mode`` is the boundary extension
    (``core/modes.py``): periodization by default; the pywt modes apply to
    the decimated pass only and give ``floor((N + hlen - 1) / 2)``
    outputs.  bfloat16 data is summed in float32 and rounded once, as
    JAX's formulations do.  ``pad_fn(x, axis, lo, hi)`` replaces the
    periodic pad (:func:`wrap_pad`): the sharded transforms pass the ring
    halo exchange (``pdwt_tpu_torch/parallel/halo.py``); it takes
    periodization only."""
    _check(x)
    backend = check_backend(backend)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    ax = axis % x.ndim
    taps = np.stack([f[::-1] for f in filters])
    if decimate and dilation != 1:
        raise ValueError("the decimated pass takes no dilation")
    if mode != "periodization":
        modes.check_mode(mode)
        if not decimate:
            raise ValueError("boundary modes other than 'periodization' apply to the "
                             "decimated DWT only (pywt's swt is periodic by definition)")
        if pad_fn is not None:
            raise ValueError("sharded halo exchange (pad_fn) requires mode='periodization'")
        # out[m] = sum_j f[j] x_ext[2m+1-j] (pywt's downsampling convolution):
        # a valid correlation of the reversed taps over x extended by
        # (hlen - 2, hlen - 1)
        xp = modes.extend(x, ax, hlen - 2, hlen - 1, mode)
        return _analysis(_acc(xp), taps, ax, backend).to(x.dtype)
    c = fwd_center(hlen) * dilation
    xe = odd_extend(x, ax) if decimate else x
    xp = (pad_fn or wrap_pad)(_acc(xe), ax, c, (hlen - 1) * dilation - c)
    return _analysis(xp, taps, ax, backend, decimate=decimate, dilation=dilation).to(x.dtype)


def synthesis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                   *, out_len: Optional[int] = None, dilation: int = 1,
                   decimated: bool = True, backend: Optional[str] = None, pad_fn=None,
                   mode: str = "periodization") -> torch.Tensor:
    """Inverse of :func:`analysis_pass` along ``axis``: input
    (B, C*K, ...) -> (B, C, ...), output channel c summing the K filter
    syntheses of its group, sliced to ``out_len`` (odd sizes).
    ``decimated=False`` is the stationary synthesis at
    ``swt_inv_center(hlen) * dilation``; the caller scales the filters by
    the 1/2 per pass.  A pywt ``mode`` takes no boundary extension: zero
    pads and shift 1, ``rec_len`` outputs at most, an even ``hlen``.
    ``backend``, ``pad_fn``: as in :func:`analysis_pass` ("fma" runs the
    decimated synthesis stuff-free, "xla" and "gather" on the zero-stuffed
    coefficients padded by ``pad_fn``)."""
    _check(x)
    backend = check_backend(backend)
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    taps = np.stack([f[::-1] for f in filters])
    ax = axis % x.ndim
    if decimated and dilation != 1:
        raise ValueError("the decimated pass takes no dilation")
    s = None
    if mode != "periodization":
        modes.check_mode(mode)
        if not decimated:
            raise ValueError("boundary modes other than 'periodization' apply to the "
                             "decimated inverse DWT only")
        if pad_fn is not None:
            raise ValueError("sharded halo exchange (pad_fn) requires mode='periodization'")
        out_len = mode_out_len(x.shape[ax], hlen, mode, out_len)
        # pywt's upsampling_convolution_valid_sf: shift 1, no extension
        if backend == "fma":
            return padded_synthesis_pass(_acc(x), filters, ax, -1, out_len).to(x.dtype)
        s, pad_fn = 1, modes.zero_pad
    xa, pad_fn = _acc(x), pad_fn or wrap_pad
    if decimated and backend == "fma":
        out = _fma_synthesis_poly(xa, taps, ax, pad_fn)
    else:
        if decimated:
            s = inv_shift(hlen) if s is None else s
            xa = zero_stuff(xa, ax)
        else:
            s = swt_inv_center(hlen) * dilation
        out = _synthesis(pad_fn(xa, ax, s, (hlen - 1) * dilation - s), taps, ax, backend,
                         dilation)
    if out_len is not None:
        out = _sl(out, ax, 0, out_len)
    return out.to(x.dtype)


def mode_out_len(m: int, hlen: int, mode: str, out_len: Optional[int]) -> int:
    """The output length of a pywt mode's synthesis of ``m`` coefficients
    (``out_len``, or the full ``rec_len`` when None); raises on an odd
    filter length (pywt's parity rule) and on an ``out_len`` past
    ``rec_len``."""
    if hlen % 2:
        raise ValueError("non-periodization inverse requires an even filter length "
                         "(pywt upsampling_convolution_valid_sf parity)")
    full = modes.rec_len(m, hlen, mode)
    if out_len is None:
        return full
    if out_len > full:
        raise ValueError(f"out_len {out_len} exceeds the mode's full inverse length {full}")
    return out_len


# ---------------------------------------------------------------------------
# the passes on an input that holds its boundary: the plain versions of the
# padded kernel entry points, and the pywt modes' passes
# ---------------------------------------------------------------------------

def padded_analysis_pass(xp: torch.Tensor, filters: Sequence[np.ndarray],
                         axis: int) -> torch.Tensor:
    """The decimated analysis of ``xp`` (B, C, H, W), which holds its
    boundary extension along ``axis``: a valid correlation, no wrap,
    ``out[n] = sum_j f[hlen-1-j] xp[2n + j]`` for the ``(N - hlen) // 2 + 1``
    outputs that the N samples hold.  Returns (B, C*K, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    ax = axis % xp.ndim
    padded_len(xp.shape[ax], len(filters[0]))
    return _fma_analysis(xp, np.stack([f[::-1] for f in filters]), ax)


def padded_len(n: int, hlen: int) -> int:
    """The outputs of :func:`padded_analysis_pass` along an axis of ``n``
    samples that hold their extension; raises below one."""
    if n < hlen:
        raise ValueError(f"a padded analysis of {hlen} taps needs at least {hlen} samples "
                         f"along the axis, got {n}")
    return (n - hlen) // 2 + 1


def check_padded_synthesis(n: int, hlen: int, c0: int, out_len: int) -> None:
    """Raise unless the ``out_len`` outputs of :func:`padded_synthesis_pass`
    at offset ``c0`` read only the ``n`` coefficients they are given: its
    even positions ``i + c0 + j`` run from ``c0`` (rounded up) to
    ``out_len + c0 + hlen - 2``, coefficient ``position / 2``."""
    if out_len < 1 or c0 < -1 or (out_len + c0 + hlen - 2) // 2 > n - 1:
        raise ValueError(f"a padded synthesis of {out_len} outputs at offset {c0} with "
                         f"{hlen} taps reads outside its {n} coefficients")


def padded_synthesis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                          c0: int, out_len: int) -> torch.Tensor:
    """The decimated synthesis of ``x`` (B, C*K, ...), which holds its
    boundary (zeros, or the periodic halo) along ``axis``, with no wrap:
    ``out[i] = sum_k sum_j rev_k[j] * U_k[i + c0 + j]`` for ``i < out_len``,
    ``U_k`` the zero-stuffed band k (``U_k[2e] = x_k[e]``), ``rev_k`` the
    reversed filter k; every coefficient it reads must lie in ``x``
    (:func:`check_padded_synthesis`).  pywt's modes take ``c0 = -1``; a
    periodization axis padded by ``poly_geometry(hlen).lo`` takes ``2 lo -
    inv_shift(hlen)``.  Returns (B, C, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    hlen = len(filters[0])
    ax = axis % x.ndim
    check_padded_synthesis(x.shape[ax], hlen, c0, out_len)
    taps = np.stack([f[::-1] for f in filters])
    out = _fma_synthesis_poly(x, taps, ax, pad_fn=modes.zero_pad, s=-c0)
    return _sl(out, ax, 0, out_len)


def padded_atrous_len(n: int, hlen: int, f: int) -> int:
    """The outputs of the padded a-trous passes along an axis of ``n``
    samples that hold their halo, ``n - (hlen - 1) f``; raises below one."""
    span = (hlen - 1) * f
    if n <= span:
        raise ValueError(f"a padded a-trous pass of {hlen} taps at dilation {f} needs more "
                         f"than {span} samples along the axis, got {n}")
    return n - span


def padded_atrous_analysis_pass(xp: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                                dilation: int) -> torch.Tensor:
    """The a-trous analysis of ``xp`` (B, C, H, W), which holds its halo
    along ``axis`` (the periodic one is ``fwd_center(hlen) * f`` below and
    the rest of the span above): a valid correlation, no wrap, ``out[n] =
    sum_j f[hlen-1-j] xp[n + j f]`` for the :func:`padded_atrous_len`
    outputs.  Returns (B, C*K, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    ax = axis % xp.ndim
    padded_atrous_len(xp.shape[ax], len(filters[0]), dilation)
    return _fma_analysis(xp, np.stack([f[::-1] for f in filters]), ax, decimate=False,
                         dilation=dilation)


def padded_atrous_synthesis_pass(x: torch.Tensor, filters: Sequence[np.ndarray], axis: int,
                                 dilation: int) -> torch.Tensor:
    """The a-trous synthesis of ``x`` (B, C*K, ...), which holds its halo
    along ``axis`` (the periodic one is ``swt_inv_center(hlen) * f`` below):
    ``out[n] = sum_k sum_j rev_k[j] x_k[n + j f]``, no wrap, for the
    :func:`padded_atrous_len` outputs; the caller folds the 1/2 per pass
    into the filters.  Returns (B, C, ...)."""
    filters = [np.asarray(f, dtype=np.float64) for f in filters]
    ax = axis % x.ndim
    padded_atrous_len(x.shape[ax], len(filters[0]), dilation)
    return _fma_synthesis(x, np.stack([f[::-1] for f in filters]), ax, dilation)
