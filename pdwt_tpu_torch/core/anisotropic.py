"""Fully separable (anisotropic, hyperbolic) wavelet transform (counterpart
of ``pdwt_tpu/core/anisotropic.py``).

Each spatial axis gets its own multi-level 1D wavedec: the tensor-product
("fully separable", pywt's ``fswavedecn``) basis that tomography stacks,
sinograms and seismic panels want when one axis resolves differently from
the others.  The transform is ``ndim`` passes of the batched 1D engine: a
pass moves its axis last, runs ``core.separable.dwt1d`` on every line along
it at once (all other axes ride the batch of kernels 7 and 8, the padded
7p and 8p under another boundary mode, 15 and 16 where a tier's route rule
accepts a bf16 level), then packs the pyramid along that axis in wavedec
order ``[A_L | D_L | D_{L-1} | ... | D_1]`` and moves the axis back.

The kernel wrappers take a contiguous (B, N) tensor, so each pass copies
its moved view in (``dwt1d`` flattens it) and the pack writes it out again.

Coefficient container: one dense tensor of the input's rank, plus the
``(shape, levels)`` pair that unpacks it; :func:`fs_slices` addresses the
per-axis blocks.  The pack concatenates a float32 approximation with bf16
details under the bf16 tiers, and ``torch.cat`` promotes them to float32,
as JAX's ``jnp.concatenate`` does.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..filters import Wavelet
from .modes import level_sizes as _mode_sizes
from .modes import per_axis
from .separable import Coeffs1D, dwt1d, idwt1d
from .shapes import level_sizes

Levels = Union[int, Sequence[int]]


def _per_axis_levels(levels: Levels, ndim_spatial: Optional[int]) -> Tuple[int, ...]:
    if isinstance(levels, int):
        if ndim_spatial is None:
            raise ValueError("scalar levels needs ndim_spatial")
        return (levels,) * ndim_spatial
    return tuple(int(lv) for lv in levels)


def _axis_blocks(n: int, lv: int, hlen: int = 2, mode: str = "periodization") -> Tuple[int, ...]:
    """Packed block lengths along one axis, coarsest first: (s_L, s_L,
    s_{L-1}, ..., s_1).  Non-periodization modes follow the pywt size rule,
    which depends on the filter length."""
    s = level_sizes(n, lv) if mode == "periodization" else _mode_sizes(n, lv, hlen, mode)
    return (s[lv],) + tuple(s[lvl] for lvl in range(lv, 0, -1))


def fs_slices(shape: Sequence[int], levels: Levels, *, mode="periodization",
              hlen: Optional[int] = None) -> Tuple[Dict[str, slice], ...]:
    """Per-axis block slices of the packed tensor: key ``"a"`` is the
    depth-``L`` approximation block, ``"d<l>"`` the level-``l`` detail block
    (l = 1 is finest).  The block that is approximation along every axis is
    ``arr[..., sl[0]['a'], sl[1]['a'], ...]``."""
    lvls = _per_axis_levels(levels, len(shape))
    modes_ax = per_axis(mode, len(shape))
    if hlen is None:
        if any(m != "periodization" for m in modes_ax):
            raise ValueError("non-periodization block sizes depend on the filter length — "
                             "pass hlen= (the wavelet's .hlen)")
        hlen = 2  # unused by the periodization size rule
    out = []
    for n, lv, m in zip(shape, lvls, modes_ax):
        keys = ["a"] + [f"d{lvl}" for lvl in range(lv, 0, -1)]
        d, pos = {}, 0
        for k, b in zip(keys, _axis_blocks(n, lv, hlen, m)):
            d[k] = slice(pos, pos + b)
            pos += b
        out.append(d)
    return tuple(out)


def pack1d(c: Coeffs1D) -> torch.Tensor:
    """``[A_L | D_L | ... | D_1]`` along the last axis."""
    return torch.cat([c.approx] + [c.details[lvl] for lvl in range(len(c.details) - 1, -1, -1)],
                     dim=-1)


def unpack1d(arr: torch.Tensor, n: int, lv: int, hlen: int = 2,
             mode: str = "periodization") -> Coeffs1D:
    """The inverse of :func:`pack1d` for a length-``n`` axis: views of
    ``arr``, details finest first."""
    parts = torch.split(arr, list(_axis_blocks(n, lv, hlen, mode)), dim=-1)
    return Coeffs1D(parts[0], tuple(parts[1:][::-1]))


def fs_dwt(x: torch.Tensor, wav: Wavelet, levels: Levels, *, ndim_spatial: Optional[int] = None,
           backend: Optional[str] = None, mode="periodization") -> torch.Tensor:
    """Fully separable forward transform over the trailing ``len(levels)``
    axes (or ``ndim_spatial`` with a scalar ``levels``; a per-axis level of
    0 leaves that axis untransformed; ``mode`` a string or one per axis).
    Returns the packed coefficient tensor (larger than the input along an
    odd or non-periodization axis: block sizes from :func:`fs_slices`).
    ``backend``: each ``dwt1d``'s route (``core/separable.py``)."""
    lvls = _per_axis_levels(levels, ndim_spatial)
    nd = len(lvls)
    modes_ax = per_axis(mode, nd)
    if nd > x.ndim:
        raise ValueError(f"{nd} spatial axes but input is {x.ndim}-D")
    y = x
    for k, lv in enumerate(lvls):
        if lv == 0:
            continue
        axis = k - nd  # negative index among the trailing axes
        c = dwt1d(y.movedim(axis, -1), wav, lv, backend=backend, mode=modes_ax[k])
        y = pack1d(c).movedim(-1, axis)
    return y


def fs_idwt(arr: torch.Tensor, wav: Wavelet, shape: Sequence[int], levels: Levels, *,
            backend: Optional[str] = None, mode="periodization") -> torch.Tensor:
    """Inverse of :func:`fs_dwt`; ``shape`` is the original size of the
    trailing spatial axes."""
    lvls = _per_axis_levels(levels, len(shape))
    nd = len(lvls)
    modes_ax = per_axis(mode, nd)
    y = arr
    for k in range(nd - 1, -1, -1):
        lv = lvls[k]
        if lv == 0:
            continue
        axis = k - nd
        c = unpack1d(y.movedim(axis, -1), shape[k], lv, wav.hlen, modes_ax[k])
        y = idwt1d(c, wav, shape[k], backend=backend, mode=modes_ax[k]).movedim(-1, axis)
    return y
