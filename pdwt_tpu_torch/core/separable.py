"""Separable multi-level 2D DWT, forward and inverse (periodization).

Counterpart of ``dwt2d``/``idwt2d`` in ``pdwt_tpu/core/separable.py`` and
of their Pallas dispatch (``_dwt2d_pallas``/``_idwt2d_pallas``).  The
coefficient layout is the same, ``[A_n, (H1,V1,D1), ..., (Hn,Vn,Dn)]``:
``Coeffs2D(approx, details)`` with ``details[i] = (H, V, D)`` of level
i+1, H being high-pass along the rows and V high-pass along the columns.
Leading dimensions act as the batch.

Every level runs through the kernel wrappers of ``pdwt_tpu_torch.kernels``:
the CUDA kernels for CUDA tensors, their plain versions for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import kernels
from ..filters import Wavelet
from . import conv
from .shapes import level_sizes


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


def check_supported(x: torch.Tensor, mode) -> None:
    """Raise on what this slice of the port does not take."""
    if not all_periodization(mode):
        raise NotImplementedError(
            f"mode={mode!r}: boundary modes other than 'periodization' come "
            "with ROADMAP queue 1, item 10")
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA path takes float32, got {x.dtype}; other dtypes come "
            "with the precision tiers (ROADMAP queue 1, item 9)")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {x.dtype}")


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((-1,) + tuple(t.shape[-2:])).contiguous()


def dwt2d(x: torch.Tensor, wav: Wavelet, levels: int, *,
          mode="periodization") -> Coeffs2D:
    """Multi-level separable 2D DWT over the trailing two axes.

    Per level, odd sizes are first extended by one sample; then one tail
    launch takes all remaining levels when ``tail_supported`` allows it,
    else one level kernel takes this level."""
    if x.ndim < 2:
        raise ValueError(f"expected at least 2D input, got shape {tuple(x.shape)}")
    check_supported(x, mode)
    batch = tuple(x.shape[:-2])
    lo, hi = wav.dec_lo, wav.dec_hi
    a = _flat(x)
    details = []
    for lvl in range(levels):
        a = conv.odd_extend(conv.odd_extend(a, -1), -2)
        remaining = levels - lvl
        if kernels.tail_supported(tuple(a.shape[-2:]), wav.hlen, remaining):
            a, dets = kernels.fwd_tail_2d_ad(a, lo, hi, remaining)
            details.extend(dets)
            break
        a, h, v, d = kernels.fwd_level_2d_ad(a, lo, hi)
        details.append((h, v, d))
    unflat = lambda t: t.reshape(batch + tuple(t.shape[1:]))
    return Coeffs2D(unflat(a), tuple(tuple(map(unflat, band)) for band in details))


def idwt2d(coeffs: Coeffs2D, wav: Wavelet, shape: Tuple[int, int], *,
           mode="periodization") -> torch.Tensor:
    """Inverse of :func:`dwt2d`; ``shape`` = (Nr, Nc) of the original image.

    The deepest k levels whose sizes halve exactly and that
    ``tail_supported`` allows run as one tail launch; each level above
    runs the level kernel and is sliced back to odd sizes."""
    check_supported(coeffs.approx, mode)
    levels = coeffs.levels
    rows = level_sizes(shape[0], levels)
    cols = level_sizes(shape[1], levels)
    lo, hi = wav.rec_lo, wav.rec_hi
    batch = tuple(coeffs.approx.shape[:-2])
    a = _flat(coeffs.approx)
    mr, mc = a.shape[-2:]
    k = 0
    while k < levels:
        i = levels - 1 - k
        if rows[i] != mr << (k + 1) or cols[i] != mc << (k + 1):
            break
        if not kernels.tail_supported((mr << (k + 1), mc << (k + 1)), wav.hlen, k + 1):
            break
        k += 1
    if k:
        dets = [tuple(map(_flat, coeffs.details[i]))
                for i in range(levels - 1, levels - 1 - k, -1)]
        a = kernels.inv_tail_2d_ad(a, dets, lo, hi)
    for i in range(levels - 1 - k, -1, -1):
        h, v, d = map(_flat, coeffs.details[i])
        y = kernels.inv_level_2d_ad(a, h, v, d, lo, hi)
        a = y[:, :rows[i], :cols[i]].contiguous()
    return a.reshape(batch + tuple(a.shape[1:]))
