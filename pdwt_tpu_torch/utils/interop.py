"""The PyWavelets coefficient formats and pywt-shaped drop-ins (counterpart
of ``pdwt_tpu/utils/interop.py``).

Containers, coarsest level first as pywt lists them:

* 1D: ``[cA_n, cD_n, ..., cD_1]``               (``pywt.wavedec``)
* 2D: ``[cA_n, (cH_n, cV_n, cD_n), ..., lvl 1]`` (``pywt.wavedec2``)
* 3D: ``[cA_n, {'aad': ..., ...}, ..., lvl 1]``  (``pywt.wavedecn``)

The port's ``Coeffs1D/2D/3D`` keep the finest level first.  pywt's ``cH``
(detail along the rows) is the port's H, and the 3D keys are
``DETAIL_KEYS_3D`` in (depth, row, column) order, so the bands map one to
one.

The drop-ins (``wavedec*``/``waverec*``, ``dwt``/``idwt``, ``dwt2``/
``idwt2``, ``swt``/``iswt``, ``swt2``/``iswt2``) take pywt's signatures and
defaults (``mode="symmetric"``, pywt's, not the reference's
periodization) and transform the trailing axes.  A tensor keeps its
device; numpy input goes to the card unless ``device=`` names another
(``utils/convert.py: image_tensor``); ``backend=`` is the transforms'
route (``core/separable.py``).  Outputs stay tensors.  The
symmetric default runs the padded kernels 1p, 2p, 7p and 8p (and the depth
products for ``wavedecn``), ``mode="periodization"`` kernels 1-4, 7 and 8,
the stationary pairs kernels 5, 6, 9 and 10 (``keep_approx=True``).
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from ..core.modes import rec_len
from ..core.separable import (Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d, iswt1d, iswt2d,
                              swt1d, swt2d)
from ..core.separable3d import DETAIL_KEYS_3D, Coeffs3D, dwt3d, idwt3d
from ..core.shapes import max_level
from ..filters import get_wavelet
from .convert import image_tensor


def to_pywt(coeffs) -> List[Any]:
    """A ``Coeffs1D/2D/3D`` as the matching pywt list (the tensors stay on
    their device)."""
    if isinstance(coeffs, Coeffs1D):
        return [coeffs.approx] + [d for d in reversed(coeffs.details)]
    if isinstance(coeffs, Coeffs2D):
        return [coeffs.approx] + [tuple(lvl) for lvl in reversed(coeffs.details)]
    if isinstance(coeffs, Coeffs3D):
        return [coeffs.approx] + [dict(zip(DETAIL_KEYS_3D, lvl))
                                  for lvl in reversed(coeffs.details)]
    raise TypeError(f"expected a Coeffs pytree, got {type(coeffs)}")


def from_pywt(clist, *, device=None) -> Any:
    """A pywt-style coefficient list as the matching ``Coeffs1D/2D/3D``
    (inverse of :func:`to_pywt`).  The level kind comes from the first
    detail entry: dict 3D, tuple or list 2D, array 1D."""
    if not isinstance(clist, (list, tuple)) or not clist:
        raise TypeError("expected a non-empty pywt coefficient list")
    t = lambda a: image_tensor(a, device)
    approx = t(clist[0])
    dets = list(clist[1:])
    if not dets:
        raise ValueError("coefficient list has no detail levels")
    first = dets[0]
    if isinstance(first, dict):
        try:
            levels = tuple(tuple(t(d[k]) for k in DETAIL_KEYS_3D) for d in reversed(dets))
        except KeyError as e:
            raise ValueError(f"3D level dict missing key {e}") from None
        return Coeffs3D(approx, levels)
    if isinstance(first, (tuple, list)):
        for d in dets:
            if len(d) != 3:
                raise ValueError("2D levels need (cH, cV, cD) triples")
        return Coeffs2D(approx, tuple(tuple(t(b) for b in d) for d in reversed(dets)))
    return Coeffs1D(approx, tuple(t(d) for d in reversed(dets)))


def _wav(wavelet):
    return get_wavelet(wavelet) if isinstance(wavelet, str) else wavelet


def dwt_max_level(data_len: int, filter_len) -> int:
    """pywt.dwt_max_level: floor(log2(data_len / (filter_len - 1)));
    ``filter_len`` an int, a wavelet or its name."""
    if not isinstance(filter_len, int):
        filter_len = _wav(filter_len).hlen
    return max_level(int(data_len), filter_len)


def _levels(shape, wav, level, ndim) -> int:
    if level is None:
        level = dwt_max_level(min(shape[-ndim:]), wav.hlen)
    if level < 0:
        raise ValueError(f"level must be >= 0, got {level}")
    return level


def wavedec(data, wavelet, mode: str = "symmetric", level=None, *, backend: Optional[str] = None, device=None) -> List[Any]:
    """pywt.wavedec over the trailing axis: [cA_n, cD_n, ..., cD_1]."""
    data = image_tensor(data, device)
    wav = _wav(wavelet)
    level = _levels(data.shape, wav, level, 1)
    if level == 0:
        return [data]
    return to_pywt(dwt1d(data, wav, level, backend=backend, mode=mode))


def wavedec2(data, wavelet, mode: str = "symmetric", level=None, *, backend: Optional[str] = None, device=None) -> List[Any]:
    """pywt.wavedec2 over the trailing two axes: [cA_n, (cH_n, cV_n,
    cD_n), ..., level 1]."""
    data = image_tensor(data, device)
    wav = _wav(wavelet)
    level = _levels(data.shape, wav, level, 2)
    if level == 0:
        return [data]
    return to_pywt(dwt2d(data, wav, level, backend=backend, mode=mode))


def wavedecn(data, wavelet, mode: str = "symmetric", level=None, *, backend: Optional[str] = None, device=None) -> List[Any]:
    """pywt.wavedecn for 3D volumes (trailing three axes): [cA_n, {'aad':
    ..., ..., 'ddd': ...}, ..., level 1].  For 1D and 2D use
    :func:`wavedec` / :func:`wavedec2`."""
    data = image_tensor(data, device)
    if data.ndim < 3:
        raise ValueError("wavedecn here is the 3D entry point; use wavedec/wavedec2 for 1D/2D")
    wav = _wav(wavelet)
    level = _levels(data.shape, wav, level, 3)
    if level == 0:
        return [data]
    return to_pywt(dwt3d(data, wav, level, backend=backend, mode=mode))


def _crop_like(a: torch.Tensor, shape, ndim: int) -> torch.Tensor:
    """pywt's waverec cA/cD alignment: per trailing axis, a reconstructed
    cA may overshoot the stored cD by exactly one sample; crop it."""
    for ax in range(-ndim, 0):
        if a.shape[ax] == shape[ax] + 1:
            a = a.narrow(ax, 0, shape[ax])
        elif a.shape[ax] != shape[ax]:
            raise ValueError(f"coefficient shape mismatch on axis {ax}: approx {a.shape[ax]} "
                             f"vs detail {shape[ax]} (corrupt list?)")
    return a


def waverec(coeffs, wavelet, mode: str = "symmetric", *, backend: Optional[str] = None, device=None) -> torch.Tensor:
    """pywt.waverec: inverse of :func:`wavedec`.  The output length is the
    finest level's full ``2M - F + 2`` (``2M`` for periodization), as
    pywt's: slice to the original length if it was odd."""
    wav = _wav(wavelet)
    a = image_tensor(coeffs[0], device)
    for d in coeffs[1:]:  # coarsest -> finest
        d = image_tensor(d, device)
        a = _crop_like(a, d.shape, 1)
        a = idwt1d(Coeffs1D(a, (d,)), wav, rec_len(d.shape[-1], wav.hlen, mode), backend=backend,
                   mode=mode)
    return a


def waverec2(coeffs, wavelet, mode: str = "symmetric", *, backend: Optional[str] = None, device=None) -> torch.Tensor:
    """pywt.waverec2: inverse of :func:`wavedec2`."""
    wav = _wav(wavelet)
    a = image_tensor(coeffs[0], device)
    for lvl in coeffs[1:]:
        h, v, d = (image_tensor(t, device) for t in lvl)
        a = _crop_like(a, h.shape, 2)
        shape = tuple(rec_len(n, wav.hlen, mode) for n in h.shape[-2:])
        a = idwt2d(Coeffs2D(a, ((h, v, d),)), wav, shape, backend=backend, mode=mode)
    return a


def waverecn(coeffs, wavelet, mode: str = "symmetric", *, backend: Optional[str] = None, device=None) -> torch.Tensor:
    """pywt.waverecn (3D): inverse of :func:`wavedecn`."""
    wav = _wav(wavelet)
    a = image_tensor(coeffs[0], device)
    for lvl in coeffs[1:]:
        bands = tuple(image_tensor(lvl[k], device) for k in DETAIL_KEYS_3D)
        a = _crop_like(a, bands[0].shape, 3)
        shape = tuple(rec_len(n, wav.hlen, mode) for n in bands[0].shape[-3:])
        a = idwt3d(Coeffs3D(a, (bands,)), wav, shape, backend=backend, mode=mode)
    return a


def dwt(data, wavelet, mode: str = "symmetric", *, backend: Optional[str] = None, device=None):
    """pywt.dwt: single-level 1D decomposition -> ``(cA, cD)``."""
    cl = wavedec(data, wavelet, mode, level=1, backend=backend, device=device)
    return cl[0], cl[1]


def idwt(cA, cD, wavelet, mode: str = "symmetric", *, backend: Optional[str] = None, device=None) -> torch.Tensor:
    """pywt.idwt: single-level 1D reconstruction; either of ``cA``/``cD``
    may be None (pywt: the missing branch is zeros)."""
    if cA is None and cD is None:
        raise ValueError("at least one of cA/cD is required")
    if cA is None:
        cA = torch.zeros_like(image_tensor(cD, device))
    if cD is None:
        cD = torch.zeros_like(image_tensor(cA, device))
    return waverec([cA, cD], wavelet, mode, backend=backend, device=device)


def dwt2(data, wavelet, mode: str = "symmetric", *, backend: Optional[str] = None, device=None):
    """pywt.dwt2: single-level 2D decomposition -> ``(cA, (cH, cV, cD))``."""
    cl = wavedec2(data, wavelet, mode, level=1, backend=backend, device=device)
    return cl[0], cl[1]


def idwt2(coeffs, wavelet, mode: str = "symmetric", *, backend: Optional[str] = None, device=None) -> torch.Tensor:
    """pywt.idwt2: inverse of :func:`dwt2`; ``coeffs = (cA, (cH, cV, cD))``
    with None entries as zeros (pywt)."""
    cA, hvd = coeffs
    bands = [None if b is None else image_tensor(b, device) for b in hvd]
    ref = next((b for b in [cA] + bands if b is not None), None)
    if ref is None:
        raise ValueError("all coefficients are None")
    ref = image_tensor(ref, device)
    cA = torch.zeros_like(ref) if cA is None else cA
    bands = [torch.zeros_like(ref) if b is None else b for b in bands]
    return waverec2([cA, tuple(bands)], wavelet, mode, backend=backend, device=device)


def swt(data, wavelet, level: int, *, backend: Optional[str] = None, device=None) -> List[Any]:
    """pywt.swt-shaped stationary transform: coarsest-first ``[(cA_n,
    cD_n), ..., (cA_1, cD_1)]`` (the per-level approximations are
    ``swt1d(keep_approx=True)``'s).  The values follow this package's
    a-trous phase, which may differ from pywt's by a shift a level."""
    c, approxs = swt1d(image_tensor(data, device), _wav(wavelet), level, backend=backend,
                       keep_approx=True)
    return [(approxs[i], c.details[i]) for i in range(level - 1, -1, -1)]


def iswt(coeffs, wavelet, *, backend: Optional[str] = None, device=None) -> torch.Tensor:
    """Inverse of :func:`swt` (the deepest approximation and every
    detail, as pywt.iswt)."""
    details = tuple(image_tensor(d, device) for _, d in reversed(coeffs))  # finest first
    return iswt1d(Coeffs1D(image_tensor(coeffs[0][0], device), details), _wav(wavelet),
                  backend=backend)


def swt2(data, wavelet, level: int, *, backend: Optional[str] = None, device=None) -> List[Any]:
    """pywt.swt2-shaped 2D stationary transform: coarsest-first ``[(cA_i,
    (cH_i, cV_i, cD_i)), ...]`` (phase as :func:`swt`)."""
    c, approxs = swt2d(image_tensor(data, device), _wav(wavelet), level, backend=backend,
                       keep_approx=True)
    return [(approxs[i], tuple(c.details[i])) for i in range(level - 1, -1, -1)]


def iswt2(coeffs, wavelet, *, backend: Optional[str] = None, device=None) -> torch.Tensor:
    """Inverse of :func:`swt2`."""
    details = tuple(tuple(image_tensor(b, device) for b in hvd) for _, hvd in reversed(coeffs))
    return iswt2d(Coeffs2D(image_tensor(coeffs[0][0], device), details), _wav(wavelet),
                  backend=backend)
