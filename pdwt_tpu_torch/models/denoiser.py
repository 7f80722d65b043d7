"""Wavelet denoising (counterpart of ``pdwt_tpu/models/denoiser.py``):
the denoising step (random circular shift, DWT or SWT, threshold, norm,
inverse, unshift; on the SWT branch an elementwise threshold fuses into
the inverse), the fully data-driven ``auto_denoise``, the averaged
``cycle_spin_denoise``, the denoising step over a device mesh,
``sharded_denoise_step``, the volume step and data-driven denoise,
``denoise_step_3d`` and ``auto_denoise_3d``, the volume step over a
device mesh, ``sharded_denoise_step_3d``, the starlet k-sigma denoise
``starlet_auto_denoise`` and the best-basis packet denoise
``packet_denoise``.  Shifts come from a ``torch.Generator`` where JAX
takes a PRNG key.  Every entry point takes ``backend=`` and passes it to
each transform it runs (``core/separable.py``'s route rule)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import ops
from ..core.separable import (_swt2d_denoise_norm1, all_periodization, dwt2d, idwt2d, iswt2d,
                              iswt2d_denoise, swt2d)
from ..core.separable3d import Coeffs3D, dwt3d, idwt3d, iswt3d, iswt3d_denoise, swt3d
from ..filters import get_wavelet
from ..ops.estimate import _MAD_TO_SIGMA, median
from ..ops.threshold import THR_ELEM, _const
from ..ops.threshold import THRESHOLD_OPS as _THRESH
from ..utils.profiling import spanned


def check_mode(mode: str) -> None:
    """Raise on a threshold type neither package has."""
    if mode not in _THRESH:
        raise ValueError(f"unknown mode {mode!r}; pick from {sorted(_THRESH)}")


def _resolve(wav):
    return get_wavelet(wav) if isinstance(wav, str) else wav


@spanned("models")
def denoise_step(img: torch.Tensor, generator: Optional[torch.Generator], wav,
                 levels: int, beta, *, swt: bool = False, mode: str = "soft",
                 normalize: bool = False, boundary="periodization",
                 backend: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One denoising step; returns ``(denoised, norm1_of_thresholded_coeffs)``.

    ``generator=None`` disables cycle spinning.  Otherwise the row and
    column shifts are drawn, in that order, uniformly in [0, Nr) and
    [0, Nc) from ``generator`` (``ops.random_shift``).  ``mode`` is the
    threshold type (soft, hard, group or garrote).  With ``swt=True``, an
    elementwise mode and a scalar ``beta`` the threshold runs inside the
    inverse's kernel and the norm comes from the un-thresholded
    coefficients: the thresholded tree is never built.  Where every level
    runs kernel 5 (float32 on the card, the kernel route) and no gradient
    is wanted, kernel 5 takes the norm as it stores the coefficients
    (``core/separable.py: _swt2d_denoise_norm1``); otherwise
    ``ops.thresholded_norm1`` takes it in plain torch.  ``boundary`` is
    the DWT's boundary extension (``core/modes.py``;
    ``mode`` names the threshold, as in the reference): anything but
    periodization on every axis takes the decimated DWT without cycle
    spinning (``ValueError`` otherwise, as JAX; the port tests
    ``all_periodization``, so a per-axis tuple of periodizations passes)."""
    if not all_periodization(boundary) and (swt or generator is not None):
        raise ValueError("boundary modes other than 'periodization' apply to the "
                         "decimated DWT without cycle spinning")
    check_mode(mode)
    wav = _resolve(wav)
    nr, nc = img.shape[-2:]
    if generator is not None:
        sr, sc = ops.random_shift(generator, (nr, nc))
        img = ops.circshift2d(img, sr, sc)
    if swt and mode in THR_ELEM and not isinstance(beta, (list, tuple)):
        fused = _swt2d_denoise_norm1(img, wav, levels, beta, mode, normalize, backend)
        if fused is None:
            coeffs = swt2d(img, wav, levels, backend=backend)
            n1 = ops.thresholded_norm1(coeffs, beta, mode=mode, normalize=normalize)
            out = iswt2d_denoise(coeffs, wav, beta, mode=mode, normalize=normalize,
                                 backend=backend)
        else:
            out, n1 = fused
    elif swt:
        coeffs = _THRESH[mode](swt2d(img, wav, levels, backend=backend), beta,
                               normalize=normalize)
        n1 = ops.norm1(coeffs)
        out = iswt2d(coeffs, wav, backend=backend)
    else:
        coeffs = _THRESH[mode](dwt2d(img, wav, levels, backend=backend, mode=boundary), beta,
                               normalize=normalize)
        n1 = ops.norm1(coeffs)
        out = idwt2d(coeffs, wav, (nr, nc), backend=backend, mode=boundary)
    if generator is not None:
        out = ops.circshift2d(out, -sr, -sc)
    return out, n1


def _auto_betas(coeffs, method: str):
    """A per-level (per-band) list (bayes, sure) or a 0-dim tensor
    (universal), on the coefficients' device."""
    if method == "bayes":
        return list(ops.bayes_thresholds(coeffs))
    if method == "sure":
        return list(ops.sure_thresholds(coeffs))
    if method == "universal":
        return ops.universal_threshold(coeffs)
    raise ValueError(f"unknown method {method!r}")


@spanned("models")
def auto_denoise(img: torch.Tensor, wav, levels: int, *, method: str = "bayes",
                 mode: str = "soft", swt: bool = False, boundary="periodization",
                 backend: Optional[str] = None) -> torch.Tensor:
    """Data-driven 2D denoise: the noise level and the thresholds come from
    the coefficients (``method``: ``"bayes"`` per band, ``"sure"`` hybrid
    SureShrink per band, ``"universal"`` one VisuShrink threshold), then
    threshold and invert.  On the SWT a universal threshold with an
    elementwise mode runs inside the inverse's kernel.  ``boundary``: the
    DWT's boundary extension, decimated DWT only (``ValueError`` with
    ``swt``, as JAX)."""
    if not all_periodization(boundary) and swt:
        raise ValueError("boundary modes apply to the decimated DWT only")
    check_mode(mode)
    wav = _resolve(wav)
    coeffs = (swt2d(img, wav, levels, backend=backend) if swt
              else dwt2d(img, wav, levels, backend=backend, mode=boundary))
    beta = _auto_betas(coeffs, method)
    if swt and mode in THR_ELEM and not isinstance(beta, list):
        return iswt2d_denoise(coeffs, wav, beta, mode=mode, backend=backend)
    coeffs = _THRESH[mode](coeffs, beta)
    if swt:
        return iswt2d(coeffs, wav, backend=backend)
    return idwt2d(coeffs, wav, tuple(img.shape[-2:]), backend=backend, mode=boundary)


@spanned("models")
def cycle_spin_denoise(img: torch.Tensor, generator: torch.Generator, wav, levels: int,
                       beta, *, spins: int = 8, mode: str = "soft",
                       normalize: bool = False, backend: Optional[str] = None) -> torch.Tensor:
    """The mean of ``spins`` randomly shifted DWT denoising steps (TI
    denoising), their shifts drawn in turn from ``generator``; summed in
    order, then divided once, as JAX's scan does."""
    wav = _resolve(wav)
    acc = torch.zeros_like(img)
    for _ in range(spins):
        out, _ = denoise_step(img, generator, wav, levels, beta, mode=mode, normalize=normalize,
                              backend=backend)
        acc = acc + out
    return acc / torch.full((), spins, dtype=acc.dtype, device=acc.device)


@spanned("models")
def sharded_denoise_step(img, wav, levels: int, beta, mesh, *, data_axis: Optional[str] = None,
                         row_axis: Optional[str] = None, col_axis: Optional[str] = None,
                         mode: str = "soft", swt: bool = False, backend: Optional[str] = None):
    """One denoising step over a (data, row, col) device mesh (no cycle
    spinning): the sharded DWT (or SWT) of ``img`` (a DTensor, or a full
    tensor that every rank passes alike), the threshold, the norm and the
    sharded inverse.  Returns ``(denoised, norm1)``: a DTensor sharded as
    the input, and a 0-dim tensor equal on every rank.

    The threshold is elementwise (group: per position over the bands), so
    it runs on each rank's shards as they are, with JAX's values; the norm
    is each rank's sum followed by ``dist.all_reduce`` over the mesh axes
    that shard the image (a replicated axis holds copies, not more of the
    image).  The ops run on the local tensors, not through DTensor
    dispatch."""
    from ..core.separable import Coeffs2D
    from ..parallel import sharded as par

    check_mode(mode)
    wav = _resolve(wav)
    axes = dict(data_axis=data_axis, row_axis=row_axis, col_axis=col_axis)
    return _sharded_step(par.dwt2d, par.idwt2d, Coeffs2D, img, tuple(img.shape[-2:]), wav,
                         levels, beta, mesh, axes, par._placements(mesh, img.ndim, **axes),
                         mode, swt, backend)


def _sharded_step(fwd, inv, tree, img, shape, wav, levels, beta, mesh, axes, placements,
                  mode, swt, backend):
    """The sharded steps' body: the sharded forward ``fwd``, the threshold
    and the norm on each rank's shards (the norm all-reduced over the mesh
    axes that shard the input), the sharded inverse ``inv`` to ``shape``;
    ``tree`` is the coefficients' type."""
    from ..parallel import sharded as par

    coeffs = fwd(img, wav, levels, mesh, swt=swt, backend=backend, **axes)
    loc = lambda t: t.to_local()
    coeffs = _THRESH[mode](tree(loc(coeffs.approx),
                                tuple(tuple(map(loc, b)) for b in coeffs.details)), beta)
    n1 = par.all_reduce_sum(ops.norm1(coeffs), mesh, tuple(axes.values()))
    glob = lambda t: par._global(t, mesh, placements)
    coeffs = tree(glob(coeffs.approx), tuple(tuple(map(glob, b)) for b in coeffs.details))
    return inv(coeffs, wav, shape, mesh, swt=swt, backend=backend, **axes), n1


@spanned("models")
def denoise_step_3d(vol: torch.Tensor, generator: Optional[torch.Generator], wav, levels: int,
                    beta, *, swt: bool = False, mode: str = "soft", normalize: bool = False,
                    backend: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One volume denoising step over the trailing three axes (random
    circular shift, 3D DWT or SWT, threshold, norm, inverse, unshift);
    returns ``(denoised, norm1_of_thresholded_coeffs)``.

    ``generator=None`` disables cycle spinning.  Otherwise the depth, row
    and column shifts are drawn, in that order, uniformly in [0, Nd),
    [0, Nr) and [0, Nc) from ``generator`` (JAX splits its key in three in
    that order).  With ``swt=True``, an elementwise mode and a scalar
    ``beta`` the threshold runs inside the inverse's kernels
    (:func:`iswt3d_denoise`) and the norm comes from the un-thresholded
    coefficients (``ops.thresholded_norm1``)."""
    check_mode(mode)
    wav = _resolve(wav)
    nd, nr, nc = vol.shape[-3:]
    if generator is not None:
        draw = lambda n: int(torch.randint(0, n, (), generator=generator,
                                           device=generator.device))
        sd, sr, sc = draw(nd), draw(nr), draw(nc)
        vol = ops.circshift3d(vol, sd, sr, sc)
    if swt and mode in THR_ELEM and not isinstance(beta, (list, tuple)):
        coeffs = swt3d(vol, wav, levels, backend=backend)
        n1 = ops.thresholded_norm1(coeffs, beta, mode=mode, normalize=normalize)
        out = iswt3d_denoise(coeffs, wav, beta, mode=mode, normalize=normalize, backend=backend)
    elif swt:
        coeffs = _THRESH[mode](swt3d(vol, wav, levels, backend=backend), beta,
                               normalize=normalize)
        n1 = ops.norm1(coeffs)
        out = iswt3d(coeffs, wav, backend=backend)
    else:
        coeffs = _THRESH[mode](dwt3d(vol, wav, levels, backend=backend), beta,
                               normalize=normalize)
        n1 = ops.norm1(coeffs)
        out = idwt3d(coeffs, wav, (nd, nr, nc), backend=backend)
    if generator is not None:
        out = ops.circshift3d(out, -sd, -sr, -sc)
    return out, n1


@spanned("models")
def auto_denoise_3d(vol: torch.Tensor, wav, levels: int, *, method: str = "bayes",
                    mode: str = "soft", swt: bool = False, backend: Optional[str] = None
                    ) -> torch.Tensor:
    """Data-driven volume denoise: the noise level from the finest
    all-high-pass band (ddd), the thresholds per band (``"bayes"``,
    ``"sure"``) or one for the tree (``"universal"``), then the threshold
    and the inverse (unfused, as JAX's)."""
    check_mode(mode)
    wav = _resolve(wav)
    coeffs = (swt3d if swt else dwt3d)(vol, wav, levels, backend=backend)
    coeffs = _THRESH[mode](coeffs, _auto_betas(coeffs, method))
    if swt:
        return iswt3d(coeffs, wav, backend=backend)
    return idwt3d(coeffs, wav, tuple(vol.shape[-3:]), backend=backend)


@spanned("models")
def sharded_denoise_step_3d(vol, wav, levels: int, beta, mesh, *,
                            data_axis: Optional[str] = None, dep_axis: Optional[str] = None,
                            row_axis: Optional[str] = None, col_axis: Optional[str] = None,
                            mode: str = "soft", swt: bool = False,
                            backend: Optional[str] = None):
    """One volume denoising step over a (data, depth, row, col) device mesh
    (no cycle spinning), :func:`sharded_denoise_step` of the volume: the
    sharded 3D DWT (or SWT) of ``vol`` (a DTensor, or a full tensor that
    every rank passes alike), the threshold on each rank's shards, the norm
    as each rank's sum all-reduced over the mesh axes that shard the volume,
    and the sharded inverse.  Returns ``(denoised, norm1)``: a DTensor
    sharded as the input, and a 0-dim tensor equal on every rank."""
    from ..parallel import sharded as par

    check_mode(mode)
    wav = _resolve(wav)
    axes = dict(data_axis=data_axis, dep_axis=dep_axis, row_axis=row_axis, col_axis=col_axis)
    return _sharded_step(par.dwt3d, par.idwt3d, Coeffs3D, vol, tuple(vol.shape[-3:]), wav,
                         levels, beta, mesh, axes, par._placements3d(mesh, vol.ndim, **axes),
                         mode, swt, backend)


@spanned("models")
def starlet_auto_denoise(x: torch.Tensor, levels: int, *, k: float = 3.0, ndim: int = 2,
                         gen: int = 2, mode: str = "soft", backend: Optional[str] = None
                         ) -> torch.Tensor:
    """Knob-free starlet denoise (Starck's k-sigma rule): the white-noise
    sigma is the MAD of the finest detail plane over 0.6745 divided by that
    plane's exact gain (``core.starlet.starlet_noise_gains``), and every
    plane is thresholded at ``k * sigma * gain_j`` before the exact gen-1/2
    reconstruction.  ``k`` is a scalar or a per-level sequence (finest
    first).  The noise estimate is the port's ``median`` (jnp's two-middle
    median), divided tensor by tensor."""
    from ..core.starlet import StarletCoeffs, istarlet, starlet, starlet_noise_gains

    thr = THR_ELEM[mode]
    c = starlet(x, levels, ndim=ndim, gen=gen, backend=backend)
    gains = starlet_noise_gains(levels, ndim, gen)
    ks = list(k) if isinstance(k, (list, tuple)) else [k] * levels
    if len(ks) != levels:
        raise ValueError(f"need {levels} k values, got {len(ks)}")
    m = median(c.details[0].abs())
    sigma = m / _const(0.6745, m) / _const(gains[0], m)
    details = tuple(thr(w, kj * sigma * g) for w, kj, g in zip(c.details, ks, gains))
    return istarlet(StarletCoeffs(c.approx, details), ndim=ndim, gen=gen, backend=backend)


@spanned("models")
def packet_denoise(img: torch.Tensor, wav, levels: int, beta=None, *, cost: str = "shannon",
                   mode: str = "soft", backend: Optional[str] = None) -> torch.Tensor:
    """Best-basis wavelet-packet denoise: the full packet tree, the
    Coifman-Wickerhauser best basis, every detail leaf thresholded (node 0
    of its depth, the pure approximation chain, kept), the reconstruction.
    ``beta=None`` takes VisuShrink's universal threshold from the depth-1
    diagonal node's MAD noise estimate, in float32.  The threshold runs
    once over each depth's node tensor (``core.packets.threshold_details``,
    the same bits as one pass a leaf)."""
    from ..core import packets as pk_mod

    wav = _resolve(wav)
    thr = THR_ELEM[mode]
    pk = pk_mod.wp2d(img, wav, levels, backend=backend)
    if beta is None:
        d1 = pk.nodes[1][..., 3, :, :].to(torch.float32)
        sigma = median(d1.abs()) * _const(_MAD_TO_SIGMA, d1)
        beta = sigma * _const(math.sqrt(2.0 * math.log(img.shape[-2] * img.shape[-1])), d1)
    leaves, _ = pk_mod.best_basis(pk, cost)
    return pk_mod.wp_reconstruct(pk_mod.threshold_details(pk, leaves, thr, beta), leaves, wav,
                                 backend=backend)
