"""Non-separable 2D DWT and SWT: one true 2D filter per subband.

Counterpart of ``pdwt_tpu/core/nonseparable.py``.  A level filters the
image with the four quads (LL, LH, HL, HH), each (hlen, hlen), and
decimates by 2 in both axes (``dwt2d_ns``) or keeps every sample with the
taps 2^(level-1) apart (``swt2d_ns``); the inverses sum the four subbands
synthesised with the inverse quads, the stationary one with the engine's
1/4.  The dispatch is JAX's:

* jointly separable quads with the same filters along both axes (every
  named wavelet's ``quad_filters``) run the separable transforms of
  ``core/separable.py``, so the separable kernels and tiers;
* jointly separable quads with other filters along the columns than along
  the rows run ``core/conv.py`` passes, columns then rows, in the input's
  dtype (bf16 is computed in float32 and rounded to bf16 after each pass,
  as JAX's conv backends do; the approximation stays bf16 there);
* genuinely 2D quads run the rank-r separable sum of :func:`_rank_decomp`:
  in an MXU mode ("bf16", or "mixed" for the decimated pair) on the
  banded-product kernels 17-18 where ``kernels.mxu_route_ns_2d`` /
  ``mxu_route_ns_swt_2d`` accept the level, otherwise as ``core/conv.py``
  passes on float32.  Exact float32 always runs the conv passes: JAX runs
  them as XLA convolutions with no Pallas kernel.

``pad_fn=`` (the ring halo exchange of ``parallel/halo.py``, which the
sharded transforms pass when rows or columns are sharded) replaces the
periodic wrap, as in JAX (``pdwt_tpu/core/nonseparable.py:132-270``), and
then no tier applies: JAX skips kernels 17-18 under a ``pad_fn``, so the
rank-r and anisotropic levels run the conv passes with the ring in the
input's dtype (bf16 summed in float32 and rounded per pass, the rank terms
added in bf16).  Isotropic quads run the sharded 2D composition of
``parallel/sharded.py`` with no MXU mode, JAX's separable call with the
``pad_fn`` on its conv backends: float32 reaches the padded kernels 1p/2p
(5p/6p for the SWT), bf16 and float64 the conv passes in their dtype.

``backend=`` (:func:`separable.auto_backend`): isotropic quads pass it to
the separable transforms; otherwise the tiers and kernels 17-18 need the
kernel route (``None`` or ``"pallas"``, as JAX's ``_auto_backend(...) !=
"pallas"`` rule), and the conv passes of the other routes take the named
formulation (``"fma"`` for ``None`` and ``"pallas"``).  Those routes run no
kernel, so float64 runs them on the card too.

Every entry point takes ``precision=`` (:func:`precision.takes_precision`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..filters import Wavelet, factor_quads
from . import conv
from . import separable as sep
from .precision import takes_precision
from .separable import BF16, F32, Coeffs2D, _flat, _unflat, auto_backend, check_dtype, mxu_mode
from .shapes import level_sizes


def _check_quads(quads) -> np.ndarray:
    q = np.asarray(quads, dtype=np.float64)
    if q.ndim != 3 or q.shape[0] != 4 or q.shape[1] != q.shape[2]:
        raise ValueError(f"quads must have shape (4, hlen, hlen), got {q.shape}")
    return q


def _try_factor(q: np.ndarray):
    """``(lo_r, hi_r, lo_c, hi_c, isotropic)`` of jointly separable quads,
    or None."""
    fac = factor_quads(q)
    if fac is None:
        return None
    lo_r, hi_r, lo_c, hi_c = fac
    return (*fac, bool(np.allclose(lo_r, lo_c) and np.allclose(hi_r, hi_c)))


def _rank_decomp(q: np.ndarray, rtol: float = 1e-12):
    """Joint separable-sum decomposition Q_s = sum_k outer(a_k^(s), b_k):
    one SVD of the stacked (4 hlen, hlen) matrix in float64 gives column
    filters ``Bc`` (r, hlen) shared by the four quads and row filters ``A``
    (4, r, hlen), r the numerical rank at ``rtol``."""
    four, h, _ = q.shape
    U, S, Vt = np.linalg.svd(q.reshape(4 * h, h), full_matrices=False)
    r = max(1, int(np.sum(S > rtol * S[0])))
    return (U[:, :r] * S[:r]).reshape(4, h, r).transpose(0, 2, 1), Vt[:r]


def _in_dtype(pass_fn, x: torch.Tensor) -> torch.Tensor:
    """A conv pass in the input's dtype: bf16 is computed in float32 and
    the result rounded to bf16."""
    if x.dtype == BF16:
        return pass_fn(x.float()).to(BF16)
    return pass_fn(x)


def _cat(ts) -> torch.Tensor:
    """Concatenate channels, promoting their dtypes as JAX does."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in ts], dim=1)


def _rank_fwd_level(a, A, Bc, f: int = 1, decimate: bool = True, pad_fn=None, backend=None):
    """One level of the rank-r sum on (B, 1, H, W): one column pass with
    the r filters b_k, then per k the four row filters a_k^(s), summed over
    k."""
    kw = {"pad_fn": pad_fn, "backend": backend}
    if not decimate:
        kw.update(dilation=f, decimate=False)
    t = conv.analysis_pass(a, list(Bc), axis=-1, **kw)
    z = None
    for k in range(Bc.shape[0]):
        w4 = conv.analysis_pass(t[:, k:k + 1], list(A[:, k]), axis=-2, **kw)
        z = w4 if z is None else z + w4
    return z


def _rank_inv_level(z, A, Bc, out_shape=None, f: int = 1, decimated: bool = True,
                    pad_fn=None, backend=None):
    """The synthesis of the rank-r sum on (B, 4, m, n): per k one row
    synthesis summing the four subbands, then one column synthesis summing
    the k terms."""
    kw = {"pad_fn": pad_fn, "backend": backend}
    if not decimated:
        kw.update(dilation=f, decimated=False)
    rows, cols = out_shape if out_shape is not None else (None, None)
    t = torch.cat([conv.synthesis_pass(z, list(A[:, k]), axis=-2, out_len=rows, **kw)
                   for k in range(A.shape[1])], dim=1)
    return conv.synthesis_pass(t, list(Bc), axis=-1, out_len=cols, **kw)


def _bands(*ts):
    """(B, R, C) kernel inputs of (B, 1, R, C) bands."""
    return [t[:, 0].contiguous() for t in ts]


def _factored(lo_r, hi_r):
    return Wavelet("ns-factored", lo_r, hi_r, lo_r, hi_r)


def _dets(z, batch):
    return tuple(_unflat(z[:, k], batch) for k in (1, 2, 3))


def _routes(backend, pad_fn):
    """(whether the tiers' kernels may run, the conv passes' formulation,
    whether isotropic quads take the sharded local composition): the tiers
    need the kernel route and no ``pad_fn`` (JAX skips kernels 17-18 under
    one); a ``pad_fn`` with no backend named keeps ``parallel/sharded.py``'s
    composition."""
    resolved = auto_backend(backend, pad_fn)
    return (resolved == "pallas" and pad_fn is None, None if resolved == "pallas" else resolved,
            pad_fn is not None and resolved is None)


@takes_precision
def dwt2d_ns(x: torch.Tensor, quads, levels: int, *, backend: Optional[str] = None,
             pad_fn=None) -> Coeffs2D:
    """Non-separable 2D DWT with the forward quads ``quads`` (4, hlen,
    hlen), periodization, ``levels`` levels, over the trailing two axes;
    ``backend``, ``pad_fn``: the route and the ring halo (module
    docstring)."""
    q = _check_quads(quads)
    if x.ndim < 2:
        raise ValueError(f"expected at least 2D input, got shape {tuple(x.shape)}")
    check_dtype(x)
    tiers, cb, local = _routes(backend, pad_fn)
    fac = _try_factor(q)
    if fac is not None and fac[4]:
        if local:
            from ..parallel.sharded import _local_dwt2d
            return _local_dwt2d(x, _factored(fac[0], fac[1]), levels, pad_fn, False, exact=True)
        return sep.dwt2d(x, _factored(fac[0], fac[1]), levels, backend=backend, pad_fn=pad_fn)
    batch = tuple(x.shape[:-2])
    a = _flat(x)[:, None]
    details = []
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c, _ = fac
        for _ in range(levels):
            t = _in_dtype(lambda u: conv.analysis_pass(u, (lo_c, hi_c), axis=-1,
                                                       pad_fn=pad_fn, backend=cb), a)
            z = _in_dtype(lambda u: conv.analysis_pass(u, (lo_r, hi_r), axis=-2,
                                                       pad_fn=pad_fn, backend=cb), t)
            a = z[:, 0:1]
            details.append(_dets(z, batch))
        return Coeffs2D(_unflat(a[:, 0], batch), tuple(details))
    A, Bc = _rank_decomp(q)
    rank, hlen = Bc.shape
    mxu = mxu_mode(x.dtype) if tiers else None
    for _ in range(levels):
        r, c = a.shape[-2:]
        if mxu and r % 2 == 0 and c % 2 == 0 and kernels.mxu_route_ns_2d(r // 2, c // 2, hlen,
                                                                         rank):
            aa, h, v, d = kernels.ns_fwd_level_2d_mxu_ad(*_bands(a), A, Bc, mxu)
        else:
            z = _rank_fwd_level(a.float() if mxu else a, A, Bc, pad_fn=pad_fn, backend=cb)
            aa, h, v, d = (z[:, k] for k in range(4))
            if mxu == "bf16":
                h, v, d = (t.to(BF16) for t in (h, v, d))
        a = aa[:, None]
        details.append(tuple(_unflat(t, batch) for t in (h, v, d)))
    return Coeffs2D(_unflat(a[:, 0], batch), tuple(details))


@takes_precision
def idwt2d_ns(coeffs: Coeffs2D, quads_inv, shape: Tuple[int, int], *,
              backend: Optional[str] = None, pad_fn=None) -> torch.Tensor:
    """Inverse of :func:`dwt2d_ns` with the inverse quads ``quads_inv``;
    ``shape`` = (Nr, Nc) of the original image (of the local shard under a
    ``pad_fn``)."""
    q = _check_quads(quads_inv)
    check_dtype(coeffs.approx)
    tiers, cb, local = _routes(backend, pad_fn)
    fac = _try_factor(q)
    if fac is not None and fac[4]:
        if local:
            from ..parallel.sharded import _local_idwt2d
            return _local_idwt2d(coeffs, _factored(fac[0], fac[1]), tuple(shape), pad_fn, False,
                                 exact=True)
        return sep.idwt2d(coeffs, _factored(fac[0], fac[1]), shape, backend=backend,
                          pad_fn=pad_fn)
    levels = coeffs.levels
    rows, cols = level_sizes(shape[0], levels), level_sizes(shape[1], levels)
    batch = tuple(coeffs.approx.shape[:-2])
    a = _flat(coeffs.approx)[:, None]
    flat = lambda i: [_flat(t)[:, None] for t in coeffs.details[i]]
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c, _ = fac
        for i in range(levels - 1, -1, -1):
            z = _cat([a, *flat(i)])
            t = _in_dtype(lambda u: conv.synthesis_pass(u, (lo_r, hi_r), axis=-2,
                                                        out_len=rows[i], pad_fn=pad_fn,
                                                        backend=cb), z)
            a = _in_dtype(lambda u: conv.synthesis_pass(u, (lo_c, hi_c), axis=-1,
                                                        out_len=cols[i], pad_fn=pad_fn,
                                                        backend=cb), t)
        return _unflat(a[:, 0], batch)
    A, Bc = _rank_decomp(q)
    rank, hlen = Bc.shape
    mxu = mxu_mode(coeffs.details[-1][0].dtype if levels else coeffs.approx.dtype
                   ) if tiers else None
    if mxu == "bf16":
        a = a.float()
    for i in range(levels - 1, -1, -1):
        h, v, d = flat(i)
        mr, mc = a.shape[-2:]
        last_bf16 = mxu == "bf16" and i == 0
        if mxu and kernels.mxu_route_ns_2d(mr, mc, hlen, rank):
            y = kernels.ns_inv_level_2d_mxu_ad(*_bands(a, h, v, d), A, Bc, mxu,
                                               BF16 if last_bf16 else F32)
            a = y[:, None, :rows[i], :cols[i]].contiguous()
        else:
            parts = [t.float() for t in (a, h, v, d)] if mxu else [a, h, v, d]
            a = _rank_inv_level(_cat(parts), A, Bc, (rows[i], cols[i]), pad_fn=pad_fn,
                                backend=cb)
            a = a.to(BF16) if last_bf16 else a
    return _unflat(a[:, 0], batch)


@takes_precision
def swt2d_ns(x: torch.Tensor, quads, levels: int, *, backend: Optional[str] = None,
             pad_fn=None) -> Coeffs2D:
    """Non-separable stationary (a-trous) 2D transform with the forward
    quads ``quads``; every band keeps the input's size.  ``backend``,
    ``pad_fn``: the route and the ring halo (module docstring)."""
    q = _check_quads(quads)
    if x.ndim < 2:
        raise ValueError(f"expected at least 2D input, got shape {tuple(x.shape)}")
    check_dtype(x)
    tiers, cb, local = _routes(backend, pad_fn)
    fac = _try_factor(q)
    if fac is not None and fac[4]:
        if local:
            from ..parallel.sharded import _local_dwt2d
            return _local_dwt2d(x, _factored(fac[0], fac[1]), levels, pad_fn, True, exact=True)
        return sep.swt2d(x, _factored(fac[0], fac[1]), levels, backend=backend, pad_fn=pad_fn)
    batch = tuple(x.shape[:-2])
    a = _flat(x)[:, None]
    details = []
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c, _ = fac
        for lvl in range(1, levels + 1):
            kw = {"dilation": 1 << (lvl - 1), "decimate": False, "pad_fn": pad_fn,
                  "backend": cb}
            t = _in_dtype(lambda u: conv.analysis_pass(u, (lo_c, hi_c), axis=-1, **kw), a)
            z = _in_dtype(lambda u: conv.analysis_pass(u, (lo_r, hi_r), axis=-2, **kw), t)
            a = z[:, 0:1]
            details.append(_dets(z, batch))
        return Coeffs2D(_unflat(a[:, 0], batch), tuple(details))
    A, Bc = _rank_decomp(q)
    rank, hlen = Bc.shape
    # mixed runs the a-trous levels exact (pdwt_tpu/core/nonseparable.py:331-333)
    mxu = sep._swt_mxu_mode(x.dtype) if tiers else None
    for lvl in range(1, levels + 1):
        r, c = a.shape[-2:]
        if mxu and kernels.mxu_route_ns_swt_2d(r, c, hlen, rank, lvl,
                                                kernels.swt_scheme(mxu, a.dtype)):
            aa, h, v, d = kernels.ns_swt_fwd_level_2d_mxu_ad(*_bands(a), A, Bc, lvl, mxu)
        else:
            z = _rank_fwd_level(a.float() if mxu else a, A, Bc, 1 << (lvl - 1), False, pad_fn,
                                cb)
            aa, h, v, d = (z[:, k] for k in range(4))
            if mxu == "bf16":
                h, v, d = (t.to(BF16) for t in (h, v, d))
        a = aa[:, None]
        details.append(tuple(_unflat(t, batch) for t in (h, v, d)))
    return Coeffs2D(_unflat(a[:, 0], batch), tuple(details))


@takes_precision
def iswt2d_ns(coeffs: Coeffs2D, quads_inv, *, backend: Optional[str] = None,
              pad_fn=None) -> torch.Tensor:
    """Inverse of :func:`swt2d_ns` with the inverse quads ``quads_inv``,
    the engine's 1/4 per level; ``backend``, ``pad_fn``: the route and the
    ring halo."""
    q = _check_quads(quads_inv)
    check_dtype(coeffs.approx)
    tiers, cb, local = _routes(backend, pad_fn)
    fac = _try_factor(q)
    if fac is not None and fac[4]:
        if local:
            from ..parallel.sharded import _local_idwt2d
            return _local_idwt2d(coeffs, _factored(fac[0], fac[1]),
                                 tuple(coeffs.approx.shape[-2:]), pad_fn, True, exact=True)
        return sep.iswt2d(coeffs, _factored(fac[0], fac[1]), backend=backend, pad_fn=pad_fn)
    batch = tuple(coeffs.approx.shape[:-2])
    a = _flat(coeffs.approx)[:, None]
    flat = lambda i: [_flat(t)[:, None] for t in coeffs.details[i]]
    if fac is not None:
        lo_r, hi_r, lo_c, hi_c, _ = fac
        rec_r, rec_c = (0.5 * lo_r, 0.5 * hi_r), (0.5 * lo_c, 0.5 * hi_c)
        for i in range(coeffs.levels - 1, -1, -1):
            kw = {"dilation": 1 << i, "decimated": False, "pad_fn": pad_fn, "backend": cb}
            z = _cat([a, *flat(i)])
            t = _in_dtype(lambda u: conv.synthesis_pass(u, rec_r, axis=-2, **kw), z)
            a = _in_dtype(lambda u: conv.synthesis_pass(u, rec_c, axis=-1, **kw), t)
        return _unflat(a[:, 0], batch)
    A, Bc = _rank_decomp(q)
    rank, hlen = Bc.shape
    mxu = sep._swt_mxu_mode(coeffs.details[-1][0].dtype if coeffs.levels
                            else coeffs.approx.dtype) if tiers else None
    if mxu == "bf16":
        a = a.float()
    for i in range(coeffs.levels - 1, -1, -1):
        h, v, d = flat(i)
        r, c = a.shape[-2:]
        last_bf16 = mxu == "bf16" and i == 0
        # the a-trous synthesis runs fd in bf16 (ns_matmul_pallas.py:477-479)
        if mxu and kernels.mxu_route_ns_swt_2d(r, c, hlen, rank, i + 1, "fd"):
            a = kernels.ns_swt_inv_level_2d_mxu_ad(*_bands(a, h, v, d), A, Bc, i + 1, mxu,
                                                   BF16 if last_bf16 else F32)[:, None]
        else:
            parts = [t.float() for t in (a, h, v, d)] if mxu else [a, h, v, d]
            a = _rank_inv_level(_cat(parts), A, 0.25 * Bc, f=1 << i, decimated=False,
                                pad_fn=pad_fn, backend=cb)
            a = a.to(BF16) if last_bf16 else a
    return _unflat(a[:, 0], batch)
