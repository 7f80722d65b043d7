"""Norms and coefficient algebra over a whole coefficient tree, 3D, 2D or 1D
(counterpart of ``pdwt_tpu/ops/norms.py``): each norm is one 0-dim tensor
on the coefficients' device, summed over the approximation and every
detail band.  bf16 bands are summed in float32, as JAX does
(``pdwt_tpu/ops/norms.py:27-28``); so are the group norms of ``norm_l21``,
unlike the group threshold, which squares in the bands' dtype."""
from __future__ import annotations

import torch

from .. import kernels
from ..utils.profiling import NORM_PATHS, recording, span, spanned
from .threshold import _SQRT2, Coeffs, _const, detail_bands


def _leaves(coeffs: Coeffs):
    yield coeffs.approx
    for _, _, x in detail_bands(coeffs):
        yield x


def _accum(x: torch.Tensor) -> torch.dtype:
    """The dtype a sum over ``x`` accumulates in: float32 for bf16."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


@spanned("ops")
def norm1(coeffs: Coeffs) -> torch.Tensor:
    """Sum of |coeff| over all subbands, approximation included."""
    return sum(torch.sum(torch.abs(x), dtype=_accum(x)) for x in _leaves(coeffs))


@spanned("ops")
def norm2sq(coeffs: Coeffs) -> torch.Tensor:
    """Squared L2 norm over all subbands, approximation included."""
    return sum(torch.sum(torch.square(x.to(_accum(x)))) for x in _leaves(coeffs))


@spanned("ops")
def add_coeffs(dst: Coeffs, src: Coeffs, alpha=1.0) -> Coeffs:
    """dst + alpha * src, band by band (the coefficient axpy).  alpha is
    rounded to each dst band's dtype; the product and the sum take the two
    bands' promoted dtype, as in JAX."""
    def axpy(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        al = (alpha.to(a.dtype) if isinstance(alpha, torch.Tensor)
              else torch.tensor(alpha, dtype=a.dtype))
        return a.to(dt) + al.to(dt) * b.to(dt)

    return type(dst)(axpy(dst.approx, src.approx),
                     tuple(axpy(a, b) if isinstance(a, torch.Tensor)
                           else tuple(axpy(x, y) for x, y in zip(a, b))
                           for a, b in zip(dst.details, src.details)))


def _group_norms(coeffs: Coeffs, i: int, do_thresh_appcoeffs: bool) -> torch.Tensor:
    """The L2 norm at each position of level i's group (its detail bands,
    and the approximation at the coarsest level under
    ``do_thresh_appcoeffs``), summed in float32 for bf16 bands."""
    det = coeffs.details[i]
    bands = (det,) if isinstance(det, torch.Tensor) else det
    acc = _accum(bands[0])
    norm2 = sum(torch.square(x.to(acc)) for x in bands)
    if do_thresh_appcoeffs and i == coeffs.levels - 1:
        norm2 = norm2 + torch.square(coeffs.approx.to(acc))
    return torch.sqrt(norm2)


def _approx_l1(coeffs: Coeffs) -> torch.Tensor:
    a = coeffs.approx
    return torch.sum(a.abs().to(_accum(a)))


@spanned("ops")
def norm_l21(coeffs: Coeffs, *, do_thresh_appcoeffs: bool = False) -> torch.Tensor:
    """Group-lasso (L2,1) norm: the sum over positions of each level's
    group norm, with ``group_soft_threshold``'s groups (that threshold is
    the proximal operator of beta times this norm).  The approximation
    joins the coarsest group under ``do_thresh_appcoeffs``, else adds its
    L1 norm."""
    total = 0.0
    for i in range(coeffs.levels):
        total = total + torch.sum(_group_norms(coeffs, i, do_thresh_appcoeffs))
    return total if do_thresh_appcoeffs else total + _approx_l1(coeffs)


@spanned("ops")
def thresholded_norm_l21(coeffs: Coeffs, beta, *, normalize: bool = False,
                         do_thresh_appcoeffs: bool = False) -> torch.Tensor:
    """``norm_l21(group_soft_threshold(coeffs, beta))`` without building
    the thresholded tree: sum max(||g|| - b, 0) over the groups g."""
    total = 0.0
    for i in range(coeffs.levels):
        norm = _group_norms(coeffs, i, do_thresh_appcoeffs)
        b = beta / (_SQRT2 ** (i + 1)) if normalize else beta
        total = total + torch.clamp_min(norm - _const(b, norm), 0).sum()
    return total if do_thresh_appcoeffs else total + _approx_l1(coeffs)


def thresholded_l1(x: torch.Tensor, b, mode: str) -> torch.Tensor:
    """The L1 norm of ``x`` thresholded at ``b`` (a number or a tensor):
    soft sum max(|x| - b, 0), hard sum |x| [|x| > b], garrote
    sum (|x| - b^2 / |x|) [|x| > b]; summed in float32 for bf16."""
    from .threshold import beta_squared

    ax = x.abs().to(_accum(x))
    if isinstance(b, torch.Tensor):
        b = b.to(ax.dtype)
    if mode == "soft":
        return torch.clamp_min(ax - b, 0).sum()
    if mode == "hard":
        return torch.where(ax > b, ax, 0.0).sum()
    if mode == "garrote":
        keep = ax > b
        safe = torch.where(keep, ax, 1.0)
        b2 = torch.as_tensor(beta_squared(b, ax), dtype=ax.dtype)
        return torch.where(keep, ax - b2 / safe, 0.0).sum()
    raise ValueError(f"thresholded_norm1 takes soft, hard or garrote, got {mode!r}")


@spanned("ops")
def thresholded_norm1(coeffs: Coeffs, beta, *, mode: str = "soft",
                      normalize: bool = False,
                      do_thresh_appcoeffs: bool = False) -> torch.Tensor:
    """``norm1(threshold(coeffs))`` without building the thresholded tree
    (:func:`thresholded_l1` a band).  ``beta`` is a scalar or a per-level
    (per-band) sequence, as for the threshold ops; ``mode`` is soft, hard
    or garrote.  This is the plain route, counted in ``NORM_PATHS["plain"]``
    while the span recorder is on; the 2D TI step's fused route takes the
    norm in kernel 5's epilogue and ends in :func:`sum_norm_partials`."""
    from .threshold import _app_beta, _resolve_beta

    if recording():
        NORM_PATHS["plain"] += 1
    total = 0.0
    for i, j, x in detail_bands(coeffs):
        total = total + thresholded_l1(x, _resolve_beta(beta, i, j, normalize), mode)
    a = coeffs.approx
    if do_thresh_appcoeffs:
        return total + thresholded_l1(a, _app_beta(beta, coeffs.levels, normalize), mode)
    return total + a.abs().sum(dtype=_accum(a))


def sum_norm_partials(partials: torch.Tensor) -> torch.Tensor:
    """The fused routes' thresholded L1 norm (``core/separable.py:
    _swt2d_denoise_norm1``, ``_dwt1d_denoise_norm1``): the partials of
    kernel 5's or kernel 7's norm launches, one a block, added by
    ``kernels.swt_norm_sum_2d``.  Under the plain route's span name, and
    counted in ``NORM_PATHS["fused"]`` while the span recorder is on."""
    with span("pdwt.ops.thresholded_norm1"):
        if recording():
            NORM_PATHS["fused"] += 1
        return kernels.swt_norm_sum_2d(partials)


@spanned("ops")
def add_approx_norm1(total: torch.Tensor, approx: torch.Tensor, beta=None, *, levels: int = 0,
                     mode: str = "soft", normalize: bool = False,
                     do_thresh_appcoeffs: bool = False):
    """The rest of the fused 1D step's norm (``Wavelets.run_denoise``):
    ``total``, the thresholded details' L1 norm from kernel 7's norm
    launches, plus sum |A| of the approximation.  Under
    ``do_thresh_appcoeffs`` A is first thresholded as the threshold ops
    threshold it (``mode`` at ``beta / sqrt(2)^levels`` under
    ``normalize``).  Returns (A as the synthesis takes it, the norm)."""
    from .threshold import THR_ELEM, _app_beta

    if do_thresh_appcoeffs:
        approx = THR_ELEM[mode](approx, _app_beta(beta, levels, normalize))
    return approx, total + torch.sum(torch.abs(approx), dtype=_accum(approx))
