"""Separable multi-level transforms: the decimated DWT and the stationary
(a-trous) SWT, forward and inverse, in 2D and batched 1D, and the fused
threshold-in-inverse of the 2D TI-denoise step.  The decimated DWT takes
every boundary mode (``mode=``, ``core/modes.py``); the SWT is periodic.

Counterpart of ``dwt2d``/``idwt2d``/``swt2d``/``iswt2d``/``iswt2d_denoise``
and ``dwt1d``/``idwt1d``/``swt1d``/``iswt1d`` in
``pdwt_tpu/core/separable.py`` and of their Pallas dispatch.  The
coefficient layout is the same, ``[A_n, (H1,V1,D1), ..., (Hn,Vn,Dn)]``:
``Coeffs2D(approx, details)`` with ``details[i] = (H, V, D)`` of level
i+1, H being high-pass along the rows and V high-pass along the columns;
in 1D ``Coeffs1D(approx, details)`` with one detail tensor per level.
The SWT keeps every band at the input's size.  Leading dimensions act as
the batch.

Every level runs through the kernel wrappers of ``pdwt_tpu_torch.kernels``:
the CUDA kernels for CUDA tensors, their plain versions for CPU tensors.

``backend=`` and ``pad_fn=`` (``pdwt_tpu/core/separable.py:129-160``,
:func:`auto_backend`).  ``None`` resolves to the override of
``conv.set_default_backend`` (or ``PDWT_TPU_BACKEND``) when one is set,
else to ``"pallas"``: the kernel route above, on every device (JAX takes
it on a TPU, and runs Pallas in interpret mode on the CPU; the port runs
the kernels' plain versions there).  ``"fma"``, ``"xla"`` and ``"gather"``
run the conv passes of ``core/conv.py`` level by level in that
formulation, on whatever device the input is on, and launch no kernel, as
JAX's conv route runs no Pallas body; float64 runs there on the card too.
``pad_fn(x, axis, lo, hi)`` replaces the periodic wrap of those passes (the
sharded transforms' ring halo): with ``backend=None`` it takes the conv
passes, and ``"pallas"`` with a ``pad_fn`` raises, as in JAX.  The conv
route takes no tier: a bf16 input stays bf16 pass by pass, as in JAX.

Boundary modes (``pdwt_tpu/core/separable.py:350-640, 906-1016``).  A
string, or one mode per axis (2D: rows, columns); all periodization is the
periodization path below.  Any other takes the mode route, one level at a
time (mode sizes do not halve, so no tail), on the rule of
:func:`mode_route`: float32 on the card with an even filter runs the padded
entry points of kernels 1 and 2 (7 and 8 in 1D) on every level, under
every tier, the forward on the signal extended per axis (``modes.extend``;
a periodization axis odd-extended and wrapped at the periodic center), the
inverse on the subbands as they are (a periodization axis with its
periodic halo), when ``backend`` is None or ``"pallas"`` and no
``pad_fn`` rides; everything else runs the plain extension route (the conv
passes with ``mode=``, JAX's fma formulation unless ``backend`` names
another, in the input's dtype), whose inverse refuses an odd filter as
JAX's does.  A per-axis tuple that mixes
in periodization holds to JAX's fma coefficients, not to JAX's TPU route,
which pads such an axis at the pywt phase (``ROADMAP.md``, "Open faults
of the reference").

The 2D TI step's norm (:func:`_swt2d_denoise_norm1`, which
``models.denoise_step`` takes): where every level runs kernel 5
(:func:`norm_route`: float32 on the card in the kernel route) and no
gradient is wanted, kernel 5 takes the thresholded L1 norm of the details
as it stores them, one partial a block, and
``ops.norms.sum_norm_partials`` adds the partials; the JAX package takes
the norm apart, in ``ops.thresholded_norm1``, which stays the route
everywhere else.  The batched 1D step's (:func:`_dwt1d_denoise_norm1`,
which ``Wavelets.run_denoise`` takes in 1D): where every level runs
kernel 7 (float32 on the card in the kernel route and the exact tier) and
no gradient is wanted, kernel 7 stores the details thresholded and takes
their L1 norm as it stores them, one partial a block; the JAX facade
thresholds the tree and takes ``norm1`` apart, which stays the route
everywhere else.

Precision tiers (``core/precision.py``; ``pdwt_tpu/core/separable.py``'s
Pallas dispatch).  The MXU mode comes from the dtype: bf16 tensors run
"bf16", float32 tensors under the ``mixed`` tier "mixed", everything else
the exact kernels.  In an MXU mode each decimated level whose geometry the
route rule (``kernels.mxu_route_2d`` / ``mxu_route_1d``) accepts runs the
banded-product kernels; the others run the exact kernels on float32.
Under "bf16" the approximation chain is float32 and the details bf16, and
the inverse's last level writes bf16.  The inverse takes its mode from the
detail dtype.  ``mixed`` runs the stationary transforms exact, as JAX
does; under "bf16" each a-trous level the route rule
(``kernels.mxu_route_swt_2d`` / ``mxu_route_1d``) accepts runs the a-trous
banded-product kernels, the others the exact kernels on float32 with the
details cast to bf16.  The mode route takes no MXU mode: JAX's
(``_use_mode_pallas``) routes by dtype.  Every entry point takes
``precision=`` (:func:`precision.takes_precision`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..filters import Wavelet
from ..utils.profiling import spanned
from . import conv, modes, precision
from .precision import takes_precision
from .shapes import level_sizes

F32, BF16 = torch.float32, torch.bfloat16


class Coeffs1D(NamedTuple):
    approx: torch.Tensor
    details: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.details)


class Coeffs2D(NamedTuple):
    approx: torch.Tensor
    details: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]

    @property
    def levels(self) -> int:
        return len(self.details)


def all_periodization(mode) -> bool:
    """True when ``mode`` (a string or a per-axis tuple) is periodization
    on every axis."""
    if isinstance(mode, str):
        return mode == "periodization"
    return all(m == "periodization" for m in mode)


def check_dtype(x: torch.Tensor) -> None:
    """Raise on a dtype no route takes."""
    if x.dtype not in (F32, torch.float64, BF16):
        raise TypeError(f"expected float32 or float64 (or bfloat16 under the precision "
                        f"tiers), got {x.dtype}")


def check_supported(x: torch.Tensor) -> None:
    """Raise on a dtype the kernel route does not take (float64 on the
    card; the conv route takes it)."""
    check_dtype(x)
    if x.device.type == "cuda" and x.dtype == torch.float64:
        raise NotImplementedError("the CUDA path takes float32, or bfloat16 under the "
                                  "precision tiers, got float64")


def auto_backend(backend: Optional[str], pad_fn, mode="periodization") -> Optional[str]:
    """JAX's ``_auto_backend`` (``pdwt_tpu/core/separable.py:129-165``):
    ``backend`` as given, else the override of ``conv.set_default_backend``,
    else ``"pallas"`` (the kernel route, on every device) unless a
    ``pad_fn`` rides (then None: the conv passes' default formulation).  A
    ``"pallas"`` override with a ``pad_fn`` falls through to None.  Under a
    boundary mode other than periodization an explicit ``"pallas"`` raises
    and a ``"pallas"`` override falls through to None (the mode route's
    kernels are :func:`_mode_padded`'s choice)."""
    override = conv._default_backend
    if not all_periodization(mode):
        if backend == "pallas":
            raise ValueError("backend='pallas' supports mode='periodization' only; "
                             "other boundary modes run on the conv backends")
        if backend is not None:
            return backend
        return None if override == "pallas" else override
    if backend is not None:
        return backend
    if override is not None:
        return None if override == "pallas" and pad_fn is not None else override
    return "pallas" if pad_fn is None else None


def kernel_route(backend: Optional[str], pad_fn, mode="periodization") -> Optional[str]:
    """The resolved backend of a periodization call: ``"pallas"`` (the
    kernel route) or the conv passes' formulation (None: the default);
    ``"pallas"`` with a ``pad_fn`` raises, as in JAX."""
    backend = auto_backend(backend, pad_fn, mode)
    if backend == "pallas" and pad_fn is not None:
        raise ValueError("pallas backend does not support pad_fn")
    return backend


def mode_route(dtype: torch.dtype, device: torch.device, hlen: int) -> str:
    """The route of a boundary-mode transform's levels.  ``"padded"``:
    float32 on a CUDA card with an even filter, every level on the padded
    entry points of kernels 1 and 2 (7 and 8 in 1D), under every tier (JAX
    routes its mode path by dtype, ``pdwt_tpu/core/separable.py:593-608``);
    the kernels take any side, so there is no size condition.
    ``"plain"``: CPU tensors, bfloat16 and odd filters, the plain extension
    route (JAX's fma formulation), whose inverse refuses an odd filter as
    JAX's does.  float64 on the card was refused before
    (:func:`check_supported`); a padded launch the kernels refuse raises,
    and nothing falls back to the plain route."""
    if device.type == "cuda" and dtype == F32 and hlen % 2 == 0:
        return "padded"
    return "plain"


def fwd_mode_pad(t: torch.Tensor, axis: int, hlen: int, mode: str,
                 pad_fn=conv.wrap_pad) -> torch.Tensor:
    """A forward level's input to the padded kernel along one axis: the
    pywt extension by (hlen - 2, hlen - 1), or on a periodization axis the
    odd extension wrapped at the periodic center by ``pad_fn`` (the ring
    halo exchange on a sharded axis, ``parallel/halo.py``); its output n
    reads samples 2n + j either way."""
    if mode == "periodization":
        c = conv.fwd_center(hlen)
        return pad_fn(conv.odd_extend(t, axis), axis, c, hlen - 1 - c)
    return modes.extend(t, axis, hlen - 2, hlen - 1, mode)


def inv_mode_pad(t: torch.Tensor, axis: int, hlen: int, mode: str, out_len: int,
                 pad_fn=conv.wrap_pad):
    """(A synthesis level's bands to the padded kernel along one axis, the
    offset ``c0`` of ``conv.padded_synthesis_pass``): a pywt axis reads the
    coefficients as they are at c0 = -1 (shift 1, JAX's checks on the
    length); a periodization axis takes its periodic halo from ``pad_fn``
    and c0 = 2 lo - inv_shift(hlen)."""
    if mode == "periodization":
        g = conv.poly_geometry(hlen)
        return pad_fn(t, axis, g.lo, g.hi), 2 * g.lo - conv.inv_shift(hlen)
    conv.mode_out_len(t.shape[axis], hlen, mode, out_len)
    return t, -1


def _common(ts) -> torch.dtype:
    return functools.reduce(torch.promote_types, [t.dtype for t in ts])


def _dwt2d_mode(x: torch.Tensor, wav: Wavelet, levels: int, mode_r: str,
                mode_c: str) -> Coeffs2D:
    """The padded mode route of :func:`dwt2d` (:func:`mode_route`), one
    level at a time: the columns (``mode_c``), then the rows (``mode_r``)."""
    batch = tuple(x.shape[:-2])
    dec = (wav.dec_lo, wav.dec_hi)
    a = _flat(x)
    details = []
    for _ in range(levels):
        xp = fwd_mode_pad(fwd_mode_pad(a, -1, wav.hlen, mode_c), -2, wav.hlen, mode_r)
        a, h, v, d = kernels.fwd_level_2d_padded_ad(xp.contiguous(), *dec)
        details.append(tuple(_unflat(t, batch) for t in (h, v, d)))
    return Coeffs2D(_unflat(a, batch), tuple(details))


def _idwt2d_mode(coeffs: Coeffs2D, wav: Wavelet, shape: Tuple[int, int], mode_r: str,
                 mode_c: str) -> torch.Tensor:
    """The padded mode route of :func:`idwt2d`, deepest level first, each
    level to its pywt (or periodization) size: the rows, then the columns."""
    levels, hlen = coeffs.levels, wav.hlen
    rows = level_sizes(shape[0], levels, hlen, mode_r)
    cols = level_sizes(shape[1], levels, hlen, mode_c)
    rec = (wav.rec_lo, wav.rec_hi)
    batch = tuple(coeffs.approx.shape[:-2])
    dt = _common([coeffs.approx] + [t for band in coeffs.details for t in band])
    a = _flat(coeffs.approx).to(dt)
    for i in range(levels - 1, -1, -1):
        bands = [a] + [_flat(t).to(dt) for t in coeffs.details[i]]
        c0 = [None, None]
        for k, t in enumerate(bands):
            t, c0[0] = inv_mode_pad(t, -2, hlen, mode_r, rows[i])
            t, c0[1] = inv_mode_pad(t, -1, hlen, mode_c, cols[i])
            bands[k] = t.contiguous()
        a = kernels.inv_level_2d_padded_ad(*bands, *rec, tuple(c0), (rows[i], cols[i]))
    return _unflat(a, batch)


def _dwt1d_mode(x: torch.Tensor, wav: Wavelet, levels: int, mode: str) -> Coeffs1D:
    """The padded mode route of :func:`dwt1d` (:func:`mode_route`)."""
    batch = tuple(x.shape[:-1])
    dec = (wav.dec_lo, wav.dec_hi)
    a = _flat1(x)
    details = []
    for _ in range(levels):
        a, d = kernels.fwd_level_1d_padded_ad(
            fwd_mode_pad(a, -1, wav.hlen, mode).contiguous(), *dec)
        details.append(_unflat(d, batch))
    return Coeffs1D(_unflat(a, batch), tuple(details))


def _idwt1d_mode(coeffs: Coeffs1D, wav: Wavelet, length: int, mode: str) -> torch.Tensor:
    """The padded mode route of :func:`idwt1d`, deepest level first."""
    sizes = level_sizes(length, coeffs.levels, wav.hlen, mode)
    rec = (wav.rec_lo, wav.rec_hi)
    batch = tuple(coeffs.approx.shape[:-1])
    dt = _common([coeffs.approx, *coeffs.details])
    a = _flat1(coeffs.approx).to(dt)
    for i in range(coeffs.levels - 1, -1, -1):
        d = _flat1(coeffs.details[i]).to(dt)
        _, c0 = inv_mode_pad(a, -1, wav.hlen, mode, sizes[i])
        a = kernels.inv_level_1d_padded_ad(a, d, *rec, c0, sizes[i])
    return _unflat(a, batch)


# ---------------------------------------------------------------------------
# the conv route: JAX's conv backends, level by level
# ---------------------------------------------------------------------------

def _cat(ts) -> torch.Tensor:
    """Concatenate channels, promoting the dtypes as JAX does."""
    dt = _common(ts)
    return torch.cat([t.to(dt) for t in ts], dim=1)


def _dwt_conv(x: torch.Tensor, wav: Wavelet, levels: int, axes, modes_ax, *,
              stationary: bool = False, backend=None, pad_fn=None, keep_approx=False):
    """The conv route of the forward transforms over the trailing
    ``len(axes)`` axes of ``x`` (as (B, 1, *spatial)): per level one
    analysis pass an axis, in ``axes`` order (columns first), under
    ``modes_ax`` (one mode an axis); the stationary levels with the taps
    2^(level-1) apart.  Returns the approximation, the details (channels
    1.. of each level) and the approximations of every level, each
    (B, 1, *spatial)."""
    dec = (wav.dec_lo, wav.dec_hi)
    a, details, approxs = x, [], []
    for lvl in range(1, levels + 1):
        kw = ({"dilation": 1 << (lvl - 1), "decimate": False} if stationary else {})
        z = a
        for ax, m in zip(axes, modes_ax):
            z = conv.analysis_pass(z, dec, axis=ax, backend=backend, pad_fn=pad_fn, mode=m,
                                   **kw)
        a = z[:, :1]
        details.append([z[:, k:k + 1] for k in range(1, z.shape[1])])
        if keep_approx:
            approxs.append(a)
    return a, details, approxs


def _idwt_conv(a: torch.Tensor, details, wav: Wavelet, axes, modes_ax, sizes=None, *,
               stationary: bool = False, backend=None, pad_fn=None) -> torch.Tensor:
    """The conv route of the inverse transforms: ``a`` and each level's
    detail bands (B, 1, *spatial), deepest level first, one synthesis pass
    an axis in ``axes`` order (the forward's reversed), each to
    ``sizes[k][i]`` of its axis (decimated), or the stationary passes with
    the taps halved."""
    rec = ((wav.rec_lo * 0.5, wav.rec_hi * 0.5) if stationary else (wav.rec_lo, wav.rec_hi))
    for i in range(len(details) - 1, -1, -1):
        z = _cat([a, *details[i]])
        for k, (ax, m) in enumerate(zip(axes, modes_ax)):
            if stationary:
                z = conv.synthesis_pass(z, rec, axis=ax, dilation=1 << i, decimated=False,
                                        backend=backend, pad_fn=pad_fn)
            else:
                z = conv.synthesis_pass(z, rec, axis=ax, out_len=sizes[k][i], backend=backend,
                                        pad_fn=pad_fn, mode=m)
        a = z
    return a


def _dwt2d_conv(x, wav, levels, backend, pad_fn, per=("periodization",) * 2, *,
                stationary=False, keep_approx=False):
    batch = tuple(x.shape[:-2])
    a, dets, apx = _dwt_conv(_flat(x)[:, None], wav, levels, (-1, -2), (per[1], per[0]),
                             stationary=stationary, backend=backend, pad_fn=pad_fn,
                             keep_approx=keep_approx)
    un = lambda t: _unflat(t[:, 0], batch)
    coeffs = Coeffs2D(un(a), tuple(tuple(un(t) for t in band) for band in dets))
    return (coeffs, tuple(un(t) for t in apx)) if keep_approx else coeffs


def _idwt2d_conv(coeffs, wav, shape, backend, pad_fn, per=("periodization",) * 2, *,
                 stationary=False):
    batch = tuple(coeffs.approx.shape[:-2])
    sizes = None
    if not stationary:
        sizes = [level_sizes(n, coeffs.levels, wav.hlen, m) for n, m in zip(shape, per)]
    dets = [[_flat(t)[:, None] for t in band] for band in coeffs.details]
    a = _idwt_conv(_flat(coeffs.approx)[:, None], dets, wav, (-2, -1), per, sizes,
                   stationary=stationary, backend=backend, pad_fn=pad_fn)
    return _unflat(a[:, 0], batch)


def _dwt1d_conv(x, wav, levels, backend, pad_fn, mode="periodization", *,
                stationary=False, keep_approx=False):
    batch = tuple(x.shape[:-1])
    a, dets, apx = _dwt_conv(_flat1(x)[:, None, None], wav, levels, (-1,), (mode,),
                             stationary=stationary, backend=backend, pad_fn=pad_fn,
                             keep_approx=keep_approx)
    un = lambda t: _unflat(t[:, 0, 0], batch)
    coeffs = Coeffs1D(un(a), tuple(un(band[0]) for band in dets))
    return (coeffs, tuple(un(t) for t in apx)) if keep_approx else coeffs


def _idwt1d_conv(coeffs, wav, length, backend, pad_fn, mode="periodization", *,
                 stationary=False):
    batch = tuple(coeffs.approx.shape[:-1])
    sizes = None if stationary else [level_sizes(length, coeffs.levels, wav.hlen, mode)]
    dets = [[_flat1(t)[:, None, None]] for t in coeffs.details]
    a = _idwt_conv(_flat1(coeffs.approx)[:, None, None], dets, wav, (-1,), (mode,), sizes,
                   stationary=stationary, backend=backend, pad_fn=pad_fn)
    return _unflat(a[:, 0, 0], batch)


def mxu_mode(dtype: torch.dtype) -> Optional[str]:
    """The banded-product mode of a dtype under the active tier: "bf16"
    for bf16, "mixed" for float32 under ``mixed``, else None (exact)."""
    if dtype == BF16:
        return "bf16"
    if dtype == F32 and precision.mixed_requested():
        return "mixed"
    return None


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((-1,) + tuple(t.shape[-2:])).contiguous()


def _unflat(t: torch.Tensor, batch: Tuple[int, ...]) -> torch.Tensor:
    return t.reshape(batch + tuple(t.shape[1:]))


def _mode_padded(backend, pad_fn, dtype: torch.dtype, device: torch.device, hlen: int) -> bool:
    """A boundary-mode call takes the padded kernels: JAX's
    ``_use_mode_pallas`` (``pdwt_tpu/core/separable.py:593-608``) asks for
    no ``pad_fn`` and a None or ``"pallas"`` preference (the explicit one,
    else the override), and :func:`mode_route` for the card's route."""
    pref = backend if backend is not None else conv._default_backend
    return (pad_fn is None and pref in (None, "pallas")
            and mode_route(dtype, device, hlen) == "padded")


@spanned("transform")
@takes_precision
def dwt2d(x: torch.Tensor, wav: Wavelet, levels: int, *, backend: Optional[str] = None,
          pad_fn=None, mode="periodization") -> Coeffs2D:
    """Multi-level separable 2D DWT over the trailing two axes.  ``mode``
    is the boundary extension, a string or (row, column) modes; anything
    but periodization takes the mode route (module docstring).
    ``backend``, ``pad_fn``: the route (module docstring).

    Per level, odd sizes are first extended by one sample; in an MXU mode a
    level the route rule accepts runs the banded-product kernel; otherwise
    one tail launch takes all remaining levels when ``tail_supported``
    allows it (on float32), else one level kernel takes this level."""
    if x.ndim < 2:
        raise ValueError(f"expected at least 2D input, got shape {tuple(x.shape)}")
    check_dtype(x)
    per = modes.per_axis(mode, 2)
    if per != ("periodization",) * 2:
        if _mode_padded(backend, pad_fn, x.dtype, x.device, wav.hlen):
            return _dwt2d_mode(x, wav, levels, *per)
        return _dwt2d_conv(x, wav, levels, auto_backend(backend, pad_fn, mode), pad_fn, per)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _dwt2d_conv(x, wav, levels, backend, pad_fn)
    check_supported(x)
    batch = tuple(x.shape[:-2])
    lo, hi = wav.dec_lo, wav.dec_hi
    mxu = mxu_mode(x.dtype)
    det_dt = BF16 if mxu == "bf16" else None
    cast = (lambda ts: tuple(t.to(det_dt) for t in ts)) if det_dt else tuple
    a = _flat(x)
    details = []
    for lvl in range(levels):
        a = conv.odd_extend(conv.odd_extend(a, -1), -2)
        r, c = a.shape[-2:]
        if mxu and kernels.mxu_route_2d(r // 2, c // 2, wav.hlen):
            a, h, v, d = kernels.fwd_level_2d_mxu_ad(a, lo, hi, mxu)
            details.append((h, v, d))
            continue
        remaining = levels - lvl
        if a.dtype != BF16 and kernels.tail_supported((r, c), wav.hlen, remaining):
            a, dets = kernels.fwd_tail_2d_ad(a, lo, hi, remaining)
            details.extend(cast(band) for band in dets)
            break
        a, h, v, d = kernels.fwd_level_2d_ad(a.float() if mxu else a, lo, hi)
        details.append(cast((h, v, d)))
    return Coeffs2D(_unflat(a, batch),
                    tuple(tuple(_unflat(t, batch) for t in band) for band in details))


@spanned("transform")
@takes_precision
def idwt2d(coeffs: Coeffs2D, wav: Wavelet, shape: Tuple[int, int], *,
           backend: Optional[str] = None, pad_fn=None, mode="periodization") -> torch.Tensor:
    """Inverse of :func:`dwt2d`; ``shape`` = (Nr, Nc) of the original image,
    ``mode`` the forward's.

    The deepest k levels whose sizes halve exactly, that ``tail_supported``
    allows and that the MXU route does not cover run as one tail launch;
    each level above runs the banded-product kernel where the route rule
    accepts it, else the level kernel, and is sliced back to odd sizes."""
    check_dtype(coeffs.approx)
    per = modes.per_axis(mode, 2)
    if per != ("periodization",) * 2:
        dt = _common([coeffs.approx] + [t for band in coeffs.details for t in band])
        if _mode_padded(backend, pad_fn, dt, coeffs.approx.device, wav.hlen):
            return _idwt2d_mode(coeffs, wav, shape, *per)
        return _idwt2d_conv(coeffs, wav, shape, auto_backend(backend, pad_fn, mode), pad_fn,
                            per)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _idwt2d_conv(coeffs, wav, shape, backend, pad_fn)
    check_supported(coeffs.approx)
    levels = coeffs.levels
    rows = level_sizes(shape[0], levels)
    cols = level_sizes(shape[1], levels)
    lo, hi = wav.rec_lo, wav.rec_hi
    batch = tuple(coeffs.approx.shape[:-2])
    mxu = mxu_mode(coeffs.details[-1][0].dtype if levels else coeffs.approx.dtype)
    f32 = (lambda t: t.float()) if mxu else (lambda t: t)
    a = _flat(coeffs.approx)
    a = a.float() if mxu == "bf16" else a
    mr, mc = a.shape[-2:]
    k = 0
    while k < levels:
        i = levels - 1 - k
        if rows[i] != mr << (k + 1) or cols[i] != mc << (k + 1):
            break
        if not kernels.tail_supported((mr << (k + 1), mc << (k + 1)), wav.hlen, k + 1):
            break
        if mxu and kernels.mxu_route_2d(rows[i] // 2, cols[i] // 2, wav.hlen):
            break  # the banded-product kernel covers this level
        k += 1
    if k:
        dets = [tuple(f32(_flat(t)) for t in coeffs.details[i])
                for i in range(levels - 1, levels - 1 - k, -1)]
        a = kernels.inv_tail_2d_ad(f32(a), dets, lo, hi)
    for i in range(levels - 1 - k, -1, -1):
        h, v, d = map(_flat, coeffs.details[i])
        last_bf16 = mxu == "bf16" and i == 0
        if mxu and kernels.mxu_route_2d(a.shape[-2], a.shape[-1], wav.hlen):
            y = kernels.inv_level_2d_mxu_ad(a, h, v, d, lo, hi, mxu, BF16 if last_bf16 else F32)
        else:
            y = kernels.inv_level_2d_ad(f32(a), f32(h), f32(v), f32(d), lo, hi)
            y = y.to(BF16) if last_bf16 else y
        a = y[:, :rows[i], :cols[i]].contiguous()
    if mxu == "bf16":  # the tail may have covered every level
        a = a.to(BF16)
    return _unflat(a, batch)


def _swt_mxu_mode(dtype: torch.dtype) -> Optional[str]:
    """``mixed`` runs the stationary transforms on the exact kernels
    (``pdwt_tpu/core/separable.py:731-736, 1108``)."""
    mxu = mxu_mode(dtype)
    return None if mxu == "mixed" else mxu


@spanned("transform")
@takes_precision
def swt2d(x: torch.Tensor, wav: Wavelet, levels: int, *, backend: Optional[str] = None,
          pad_fn=None, keep_approx: bool = False):
    """Stationary (a-trous) 2D transform over the trailing two axes: level
    L filters with taps ``2^(L-1)`` apart, one kernel launch per level (in
    bf16, the a-trous banded-product kernel where the route rule accepts
    the level).  ``keep_approx=True`` also returns the approximations
    ``(A_1, ..., A_levels)``, as ``(coeffs, approxs)``.  ``backend``,
    ``pad_fn``: the route (module docstring)."""
    if x.ndim < 2:
        raise ValueError(f"expected at least 2D input, got shape {tuple(x.shape)}")
    check_dtype(x)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _dwt2d_conv(x, wav, levels, backend, pad_fn, stationary=True,
                           keep_approx=keep_approx)
    check_supported(x)
    batch = tuple(x.shape[:-2])
    mxu = _swt_mxu_mode(x.dtype)
    a = _flat(x)
    details, approxs = [], []
    for lvl in range(1, levels + 1):
        if mxu and kernels.mxu_route_swt_2d(a.shape[-2], a.shape[-1], wav.hlen, lvl):
            a, h, v, d = kernels.swt_fwd_level_2d_mxu_ad(a, wav.dec_lo, wav.dec_hi, lvl, mxu)
        else:
            a, h, v, d = kernels.swt_fwd_level_2d_ad(a.float() if mxu else a, wav.dec_lo,
                                                     wav.dec_hi, lvl)
            if mxu:
                h, v, d = (t.to(BF16) for t in (h, v, d))
        details.append(tuple(_unflat(t, batch) for t in (h, v, d)))
        if keep_approx:
            approxs.append(_unflat(a, batch))
    coeffs = Coeffs2D(_unflat(a, batch), tuple(details))
    return (coeffs, tuple(approxs)) if keep_approx else coeffs


def thresholds_in_kernel(beta, backend: Optional[str]) -> bool:
    """Do :func:`iswt2d_denoise` and ``iswt3d_denoise`` threshold inside
    their synthesis kernels?  The kernel route with a scalar ``beta``; a
    per-level (per-band) sequence and the conv backends take the threshold
    ops (JAX's rule)."""
    return auto_backend(backend, None) == "pallas" and not isinstance(beta, (list, tuple))


def norm_route(x: torch.Tensor, backend: Optional[str]) -> bool:
    """Does every level of ``swt2d(x, backend=backend)`` run kernel 5, so
    that its epilogue can take the thresholded L1 norm?  float32 on the
    card in the kernel route: the exact tier, or ``mixed``, which runs the
    stationary transforms exact.  bf16 (the tiers), the conv backends and
    CPU tensors take the plain route."""
    return x.is_cuda and x.dtype == F32 and kernel_route(backend, None) == "pallas"


@spanned("transform")
def _swt2d_denoise_norm1(x: torch.Tensor, wav: Wavelet, levels: int, beta, mode: str,
                         normalize: bool, backend: Optional[str] = None):
    """``denoise_step``'s SWT step with the norm taken by kernel 5:
    ``(iswt2d_denoise(swt2d(x), beta), thresholded_norm1(swt2d(x), beta))``
    for a scalar ``beta`` (a number or a one-element tensor, divided by
    sqrt(2)^(i+1) at level i+1 under ``normalize``).  Kernel 5 sums each
    level's thresholded H, V and D (and |A| at the last level) as it
    stores them, and each level's beta is made on the card once for both
    the norm and kernel 6's threshold.  None where the fused route does
    not serve: autograd wants a gradient of ``x`` or ``beta``,
    :func:`norm_route` refuses ``x``, or there is no level; the caller
    then takes the plain route."""
    from ..ops.norms import sum_norm_partials

    grad = torch.is_grad_enabled() and (
        x.requires_grad or (isinstance(beta, torch.Tensor) and beta.requires_grad))
    if grad or x.ndim < 2 or levels < 1 or not norm_route(x, backend):
        return None
    batch = tuple(x.shape[:-2])
    a = _flat(x)
    B, R, C = a.shape
    if normalize:
        betas = [kernels.beta_buffer(beta / math.sqrt(2.0) ** lvl, a.device)
                 for lvl in range(1, levels + 1)]
    else:
        betas = [kernels.beta_buffer(beta, a.device)] * levels
    slots = [kernels.swt_norm_slots(B, R, C, wav.hlen, lvl) for lvl in range(1, levels + 1)]
    partials = torch.empty(sum(slots), dtype=F32, device=a.device)
    details, off = [], 0
    for lvl, n, b in zip(range(1, levels + 1), slots, betas):
        a, h, v, d = kernels.swt_fwd_level_2d(a, wav.dec_lo, wav.dec_hi, lvl,
                                              norm=(mode, b, partials[off:off + n],
                                                    lvl == levels))
        details.append((h, v, d))
        off += n
    n1 = sum_norm_partials(partials)
    out = _iswt2d_thresholded(Coeffs2D(a, tuple(details)), wav, lambda lvl: betas[lvl - 1],
                              mode)
    return _unflat(out, batch), n1


def _iswt2d_levels(coeffs: Coeffs2D, wav: Wavelet, level_fn, a_fn=None) -> torch.Tensor:
    """Invert a 2D SWT deepest level first.  ``level_fn(a, h, v, d, level,
    mxu, out_dtype)`` runs one level on the banded-product kernel (``mxu``
    set, the route rule accepting it) or on the exact kernel (``mxu`` None,
    float32 bands in an MXU mode); in bf16 the last level writes bf16.
    ``a_fn`` maps the float32 approximation first."""
    batch = tuple(coeffs.approx.shape[:-2])
    mxu = _swt_mxu_mode(coeffs.details[-1][0].dtype if coeffs.levels else coeffs.approx.dtype)
    a = _flat(coeffs.approx)
    a = a.float() if mxu == "bf16" else a
    if a_fn is not None:
        a = a_fn(a)
    for i in range(coeffs.levels - 1, -1, -1):
        h, v, d = map(_flat, coeffs.details[i])
        out_dt = BF16 if mxu == "bf16" and i == 0 else F32
        if mxu and kernels.mxu_route_swt_2d(a.shape[-2], a.shape[-1], wav.hlen, i + 1):
            a = level_fn(a, h, v, d, i + 1, mxu, out_dt)
        elif mxu:
            a = level_fn(a.float(), h.float(), v.float(), d.float(), i + 1, None,
                         None).to(out_dt)
        else:
            a = level_fn(a, h, v, d, i + 1, None, None)
    return _unflat(a, batch)


@spanned("transform")
@takes_precision
def iswt2d(coeffs: Coeffs2D, wav: Wavelet, *, backend: Optional[str] = None,
           pad_fn=None) -> torch.Tensor:
    """Inverse of :func:`swt2d`, one kernel launch per level, deepest first
    (``backend``, ``pad_fn``: the route, module docstring)."""
    check_dtype(coeffs.approx)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _idwt2d_conv(coeffs, wav, None, backend, pad_fn, stationary=True)
    check_supported(coeffs.approx)
    lo, hi = wav.rec_lo, wav.rec_hi

    def level(a, h, v, d, lvl, mxu, out_dt):
        if mxu:
            return kernels.swt_inv_level_2d_mxu_ad(a, h, v, d, lo, hi, lvl, mxu, out_dt)
        return kernels.swt_inv_level_2d_ad(a, h, v, d, lo, hi, lvl)

    return _iswt2d_levels(coeffs, wav, level)


@spanned("transform")
@takes_precision
def iswt2d_denoise(coeffs: Coeffs2D, wav: Wavelet, beta, *, mode: str = "soft",
                   normalize: bool = False, do_thresh_appcoeffs: bool = False,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Threshold the details and invert the SWT in one pass per level: the
    same values as ``<mode>_threshold`` followed by :func:`iswt2d`, with
    the threshold inside the synthesis kernel, so thresholded details are
    never stored.  ``mode`` is soft, hard or garrote; a scalar ``beta`` (a
    number or a one-element tensor, differentiable) is divided by
    sqrt(2)^(i+1) at level i+1 under ``normalize``; a per-level (per-band)
    sequence goes through the threshold ops and :func:`iswt2d`, and so does
    every ``backend`` but the kernel route (JAX's rule)."""
    from ..ops.threshold import THR_ELEM, THRESHOLD_OPS, _app_beta

    if mode not in THR_ELEM:
        raise ValueError(f"the fused denoise takes {sorted(THR_ELEM)}, got {mode!r}")
    backend = auto_backend(backend, None)
    if not thresholds_in_kernel(beta, backend):
        return iswt2d(THRESHOLD_OPS[mode](coeffs, beta, normalize=normalize,
                                          do_thresh_appcoeffs=do_thresh_appcoeffs), wav,
                      backend=backend)
    check_supported(coeffs.approx)
    app = None
    if do_thresh_appcoeffs:
        app = lambda a: THR_ELEM[mode](a, _app_beta(beta, coeffs.levels, normalize))
    return _iswt2d_thresholded(
        coeffs, wav, lambda lvl: beta / math.sqrt(2.0) ** lvl if normalize else beta, mode, app)


def _iswt2d_thresholded(coeffs: Coeffs2D, wav: Wavelet, beta_at, mode: str, app=None):
    """:func:`iswt2d_denoise`'s kernel route: ``beta_at(level)`` thresholds
    the details of each level; ``app`` maps the approximation first."""
    lo, hi = wav.rec_lo, wav.rec_hi

    def level(a, h, v, d, lvl, mxu, out_dt):
        bi = beta_at(lvl)
        if mxu:
            return kernels.swt_inv_level_2d_mxu_denoise_ad(a, h, v, d, bi, lo, hi, lvl, mxu,
                                                           mode, out_dt)
        return kernels.swt_inv_level_2d_denoise_ad(a, h, v, d, bi, lo, hi, lvl, mode)

    return _iswt2d_levels(coeffs, wav, level, app)


# ---------------------------------------------------------------------------
# batched 1D, along the last axis
# ---------------------------------------------------------------------------

def _flat1(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).contiguous()


def _check_1d(x: torch.Tensor) -> None:
    if x.ndim < 1:
        raise ValueError(f"expected at least 1D input, got shape {tuple(x.shape)}")


@spanned("transform")
@takes_precision
def dwt1d(x: torch.Tensor, wav: Wavelet, levels: int, *, backend: Optional[str] = None,
          pad_fn=None, mode="periodization") -> Coeffs1D:
    """Multi-level 1D DWT along the last axis (``mode``: the boundary
    extension, a string or a one-mode tuple), one level kernel launch per
    level (the banded-product kernel where an MXU mode's route rule
    accepts the level); an odd length is first extended by one sample.
    ``backend``, ``pad_fn``: the route (module docstring)."""
    _check_1d(x)
    check_dtype(x)
    (m,) = modes.per_axis(mode, 1)
    if m != "periodization":
        if _mode_padded(backend, pad_fn, x.dtype, x.device, wav.hlen):
            return _dwt1d_mode(x, wav, levels, m)
        return _dwt1d_conv(x, wav, levels, auto_backend(backend, pad_fn, m), pad_fn, m)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _dwt1d_conv(x, wav, levels, backend, pad_fn)
    check_supported(x)
    batch = tuple(x.shape[:-1])
    mxu = mxu_mode(x.dtype)
    a = _flat1(x)
    details = []
    for _ in range(levels):
        a = conv.odd_extend(a, -1)
        if mxu and kernels.mxu_route_1d(a.shape[0], a.shape[1], wav.hlen):
            a, d = kernels.fwd_level_1d_mxu_ad(a, wav.dec_lo, wav.dec_hi, mxu)
        else:
            a, d = kernels.fwd_level_1d_ad(a.float() if mxu else a, wav.dec_lo, wav.dec_hi)
            d = d.to(BF16) if mxu == "bf16" else d
        details.append(_unflat(d, batch))
    return Coeffs1D(_unflat(a, batch), tuple(details))


@spanned("transform")
def _dwt1d_denoise_norm1(x: torch.Tensor, wav: Wavelet, levels: int, beta, mode: str,
                         normalize: bool, backend: Optional[str] = None):
    """``Wavelets.run_denoise``'s 1D DWT step with the threshold and the
    details' norm taken by kernel 7: ``(c, n)`` where ``c`` is
    ``dwt1d(x)`` with its details thresholded (``mode`` soft, hard or
    garrote at a scalar ``beta``, a number or a one-element tensor, divided
    by sqrt(2)^(i+1) at level i+1 under ``normalize``; the approximation as
    it is) and ``n`` the L1 norm of those details.  The levels run as
    :func:`dwt1d`'s exact ones, and each level's beta is made on the card
    once.  None where the fused route does not serve: autograd wants a
    gradient of ``x`` or ``beta``, ``beta`` is a sequence or has more than
    one element, ``mode`` is another threshold, there is no level, or ``x``
    is not float32 on the card in the kernel route and the exact tier
    (:func:`norm_route`, and no MXU mode: ``mixed`` runs kernel 15); the
    caller then takes the plain route."""
    from ..ops.norms import sum_norm_partials
    from ..ops.threshold import THR_ELEM

    if (isinstance(beta, (list, tuple)) or mode not in THR_ELEM
            or (isinstance(beta, torch.Tensor) and beta.numel() != 1)):
        return None
    grad = torch.is_grad_enabled() and (
        x.requires_grad or (isinstance(beta, torch.Tensor) and beta.requires_grad))
    if (grad or x.ndim < 1 or levels < 1 or not norm_route(x, backend)
            or mxu_mode(x.dtype) is not None):
        return None
    batch = tuple(x.shape[:-1])
    a = _flat1(x)
    if normalize:
        betas = [kernels.beta_buffer(beta / math.sqrt(2.0) ** lvl, a.device)
                 for lvl in range(1, levels + 1)]
    else:
        betas = [kernels.beta_buffer(beta, a.device)] * levels
    details, partials = [], []
    for b in betas:
        a = conv.odd_extend(a, -1)
        a, d, p = kernels.fwd_level_1d_norm(a, wav.dec_lo, wav.dec_hi, norm=(mode, b))
        details.append(_unflat(d, batch))
        partials.append(p)
    return (Coeffs1D(_unflat(a, batch), tuple(details)),
            sum_norm_partials(torch.cat(partials)))


@spanned("transform")
@takes_precision
def idwt1d(coeffs: Coeffs1D, wav: Wavelet, length: int, *, backend: Optional[str] = None,
           pad_fn=None, mode="periodization") -> torch.Tensor:
    """Inverse of :func:`dwt1d`; ``length`` is the original signal's,
    ``mode`` the forward's.  Each
    level runs one level kernel, deepest first, and is sliced back to its
    odd length.  ``backend``, ``pad_fn``: the route (module docstring)."""
    check_dtype(coeffs.approx)
    (m,) = modes.per_axis(mode, 1)
    if m != "periodization":
        dt = _common([coeffs.approx, *coeffs.details])
        if _mode_padded(backend, pad_fn, dt, coeffs.approx.device, wav.hlen):
            return _idwt1d_mode(coeffs, wav, length, m)
        return _idwt1d_conv(coeffs, wav, length, auto_backend(backend, pad_fn, m), pad_fn, m)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _idwt1d_conv(coeffs, wav, length, backend, pad_fn)
    check_supported(coeffs.approx)
    sizes = level_sizes(length, coeffs.levels)
    batch = tuple(coeffs.approx.shape[:-1])
    mxu = mxu_mode(coeffs.details[-1].dtype if coeffs.levels else coeffs.approx.dtype)
    a = _flat1(coeffs.approx)
    a = a.float() if mxu == "bf16" else a
    for i in range(coeffs.levels - 1, -1, -1):
        d = _flat1(coeffs.details[i])
        last_bf16 = mxu == "bf16" and i == 0
        if mxu and kernels.mxu_route_1d(a.shape[0], 2 * a.shape[1], wav.hlen):
            y = kernels.inv_level_1d_mxu_ad(a, d, wav.rec_lo, wav.rec_hi, mxu,
                                            BF16 if last_bf16 else F32)
        else:
            if mxu:
                a, d = a.float(), d.float()
            y = kernels.inv_level_1d_ad(a, d, wav.rec_lo, wav.rec_hi)
            y = y.to(BF16) if last_bf16 else y
        a = y[:, :sizes[i]].contiguous()
    return _unflat(a, batch)


@spanned("transform")
@takes_precision
def swt1d(x: torch.Tensor, wav: Wavelet, levels: int, *, backend: Optional[str] = None,
          pad_fn=None, keep_approx: bool = False):
    """Stationary (a-trous) 1D transform along the last axis, one kernel
    launch per level; ``keep_approx`` as in :func:`swt2d`; ``backend``,
    ``pad_fn``: the route (module docstring)."""
    _check_1d(x)
    check_dtype(x)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _dwt1d_conv(x, wav, levels, backend, pad_fn, stationary=True,
                           keep_approx=keep_approx)
    check_supported(x)
    batch = tuple(x.shape[:-1])
    mxu = _swt_mxu_mode(x.dtype)
    a = _flat1(x)
    details, approxs = [], []
    for lvl in range(1, levels + 1):
        if mxu and kernels.mxu_route_1d(a.shape[0], a.shape[1], wav.hlen, level=lvl):
            a, d = kernels.swt_fwd_level_1d_mxu_ad(a, wav.dec_lo, wav.dec_hi, lvl, mxu)
        else:
            a, d = kernels.swt_fwd_level_1d_ad(a.float() if mxu else a, wav.dec_lo,
                                               wav.dec_hi, lvl)
            d = d.to(BF16) if mxu else d
        details.append(_unflat(d, batch))
        if keep_approx:
            approxs.append(_unflat(a, batch))
    coeffs = Coeffs1D(_unflat(a, batch), tuple(details))
    return (coeffs, tuple(approxs)) if keep_approx else coeffs


@spanned("transform")
@takes_precision
def iswt1d(coeffs: Coeffs1D, wav: Wavelet, *, backend: Optional[str] = None,
           pad_fn=None) -> torch.Tensor:
    """Inverse of :func:`swt1d`, one kernel launch per level, deepest first
    (``backend``, ``pad_fn``: the route, module docstring)."""
    check_dtype(coeffs.approx)
    backend = kernel_route(backend, pad_fn)
    if backend != "pallas":
        return _idwt1d_conv(coeffs, wav, None, backend, pad_fn, stationary=True)
    check_supported(coeffs.approx)
    batch = tuple(coeffs.approx.shape[:-1])
    mxu = _swt_mxu_mode(coeffs.details[-1].dtype if coeffs.levels else coeffs.approx.dtype)
    a = _flat1(coeffs.approx)
    a = a.float() if mxu else a
    for i in range(coeffs.levels - 1, -1, -1):
        d = _flat1(coeffs.details[i])
        last_bf16 = mxu == "bf16" and i == 0
        if mxu and kernels.mxu_route_1d(a.shape[0], a.shape[1], wav.hlen, level=i + 1):
            a = kernels.swt_inv_level_1d_mxu_ad(a, d, wav.rec_lo, wav.rec_hi, i + 1, mxu,
                                                BF16 if last_bf16 else F32)
        else:
            a = kernels.swt_inv_level_1d_ad(a.float() if mxu else a, d.float() if mxu else d,
                                            wav.rec_lo, wav.rec_hi, i + 1)
            a = a.to(BF16) if last_bf16 else a
    return _unflat(a, batch)
