"""Spatially sharded fully separable (anisotropic) transform: counterpart
of ``pdwt_tpu/parallel/anisotropic.py`` on ``torch.distributed``.

``core.anisotropic`` is ``ndim`` independent passes of the batched 1D
engine, so the sharded transform is the sharded 1D story applied per axis:
each pass moves its axis last and runs the local 1D composition
(``sharded._local_dwt1d`` / ``_local_idwt1d``: the padded kernels 7p and 8p,
15p and 16p where a tier's route rule accepts the shard) with the periodic
pad of that axis taken by the ring halo exchange (``make_pad_fn``) when a
mesh axis shards it; the other axes, sharded or not, ride the batch with
no communication.

The pack.  The packed pyramid ``[A_L | D_L | ... | D_1]`` is the layout of
the single-device :func:`pdwt_tpu_torch.core.anisotropic.fs_dwt`, and its
block boundaries are not shard-aligned: rank r holds piece r of every
block, while piece r of the packed axis holds other blocks' samples.  JAX
concatenates the globally sharded blocks outside ``shard_map`` and lets
XLA reshard.  Here the relayout is explicit: each rank concatenates its
pieces, one all-gather over the axis's ring collects every rank's, and
each rank cuts its own piece of the packed axis out of them (the inverse
gathers the packed axis and cuts each block's piece).  One all-gather a
sharded pass, each way (:data:`COLLECTIVES` counts them); a gloo group
stages card tensors through the host, as the halo exchange does.  The
result equals the single-device transform, layout included.

Divisibility: a sharded axis with level ``lv`` needs ``size % (n_shards *
2**lv) == 0``, JAX's rule and message; an unsharded axis only the core
transform's rules (odd sizes fine).  Periodization only, as in JAX.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..core.anisotropic import _axis_blocks, _per_axis_levels, pack1d, unpack1d
from ..core.separable import Coeffs1D, dwt1d, idwt1d
from ..filters import Wavelet
from .halo import make_pad_fn
from .sharded import (_axis_size, _check_div, _global, _local, _local_dwt1d, _local_idwt1d,
                      _use_local_kernels)

Levels = Union[int, Sequence[int]]

#: all-gathers issued by the packs and unpacks of sharded passes
COLLECTIVES = {"all_gather": 0}


def _norm_axes(axes: Sequence[Optional[str]], levels: Levels):
    axes = tuple(axes)
    lvls = _per_axis_levels(levels, len(axes))
    if len(lvls) != len(axes):
        raise ValueError(f"levels ({len(lvls)} axes) and axes ({len(axes)}) disagree")
    return axes, lvls


def _placements(mesh, ndim: int, nd: int, data_axis, axes):
    """Shard(0) on ``data_axis``, Shard(ndim - nd + k) on ``axes[k]``,
    Replicate on every other mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    if data_axis is not None:
        if ndim == nd:
            raise ValueError("data_axis given but input has no batch dim")
        dims[data_axis] = 0
    for k, name in enumerate(axes):
        if name is not None:
            dims[name] = ndim - nd + k
    for name in dims:
        _axis_size(mesh, name)  # names a mesh axis
    return tuple(Shard(dims[n]) if n in dims else Replicate() for n in mesh.mesh_dim_names)


def _gather_last(t: torch.Tensor, mesh, axis_name: str) -> List[torch.Tensor]:
    """Every rank's ``t`` along ``axis_name``'s ring, in ring order (one
    all-gather; 16-bit types travel as int16, bit for bit)."""
    group = mesh.get_group(axis_name)
    host = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    src = (t.cpu() if host else t).contiguous()
    wire = src.view(torch.int16) if src.element_size() == 2 else src
    outs = [torch.empty_like(wire) for _ in range(_axis_size(mesh, axis_name))]
    dist.all_gather(outs, wire, group=group)
    COLLECTIVES["all_gather"] += 1
    outs = [o.view(src.dtype) for o in outs]
    return [o.to(t.device) for o in outs] if host else outs


def _pack_sharded(c: Coeffs1D, mesh, axis_name: Optional[str]) -> torch.Tensor:
    """This rank's piece of the packed axis (the last): the local pack on
    an unsharded axis, else the relayout through one all-gather."""
    n = _axis_size(mesh, axis_name)
    if n == 1:
        return pack1d(c)
    loc = pack1d(c)
    lens = [c.approx.shape[-1]] + [c.details[i].shape[-1] for i in range(c.levels - 1, -1, -1)]
    pieces = [torch.split(p, lens, dim=-1) for p in _gather_last(loc, mesh, axis_name)]
    full = torch.cat([pieces[r][b] for b in range(len(lens)) for r in range(n)], dim=-1)
    step = full.shape[-1] // n
    return full.narrow(-1, mesh.get_local_rank(axis_name) * step, step)


def _unpack_sharded(y: torch.Tensor, n_global: int, lv: int, mesh,
                    axis_name: Optional[str]) -> Coeffs1D:
    """This rank's pieces of every block of the packed last axis."""
    n = _axis_size(mesh, axis_name)
    if n == 1:
        return unpack1d(y, n_global, lv)
    full = torch.cat(_gather_last(y, mesh, axis_name), dim=-1)
    me, parts, pos = mesh.get_local_rank(axis_name), [], 0
    for b in _axis_blocks(n_global, lv):
        parts.append(full.narrow(-1, pos + me * (b // n), b // n))
        pos += b
    return Coeffs1D(parts[0], tuple(parts[1:][::-1]))


def fs_dwt(x, wav: Wavelet, levels: Levels, mesh, *, axes: Sequence[Optional[str]],
           data_axis: Optional[str] = None, backend: Optional[str] = None):
    """Sharded fully separable forward transform over the trailing
    ``len(axes)`` axes of ``x`` (a DTensor, or a full tensor, placed with
    the input sharding): ``axes[k]`` names the mesh axis the k-th spatial
    dim is sharded over (None: unsharded).  Returns the packed coefficient
    DTensor, sharded as the input, globally equal to the single-device
    :func:`core.anisotropic.fs_dwt`.  ``backend``: each axis's 1D route
    (``parallel/sharded.py``, JAX's ``_use_local_pallas``)."""
    axes, lvls = _norm_axes(axes, levels)
    nd = len(axes)
    if nd > x.ndim:
        raise ValueError(f"{nd} spatial axes but input is {x.ndim}-D")
    for k, (name, lv) in enumerate(zip(axes, lvls)):
        if name is not None and lv > 0:
            _check_div(f"axis {k}", x.shape[x.ndim - nd + k], _axis_size(mesh, name), lv,
                       swt=False)
    placements = _placements(mesh, x.ndim, nd, data_axis, axes)
    y = _local(x, mesh, placements)
    for k, lv in enumerate(lvls):
        if lv == 0:
            continue
        ax = x.ndim - nd + k
        pad_fn = make_pad_fn(mesh, None, axes[k])
        if _use_local_kernels(backend):
            c = _local_dwt1d(y.movedim(ax, -1), wav, lv, pad_fn, False)
        else:
            c = dwt1d(y.movedim(ax, -1), wav, lv, backend=backend, pad_fn=pad_fn)
        y = _pack_sharded(c, mesh, axes[k]).movedim(-1, ax)
    return _global(y, mesh, placements)


def fs_idwt(arr, wav: Wavelet, shape: Sequence[int], levels: Levels, mesh, *,
            axes: Sequence[Optional[str]], data_axis: Optional[str] = None,
            backend: Optional[str] = None):
    """Inverse of :func:`fs_dwt`; ``shape`` is the original size of the
    trailing spatial axes."""
    axes, lvls = _norm_axes(axes, levels)
    nd = len(axes)
    for k, (name, lv) in enumerate(zip(axes, lvls)):
        if name is not None and lv > 0:
            _check_div(f"axis {k}", shape[k], _axis_size(mesh, name), lv, swt=False)
    placements = _placements(mesh, arr.ndim, nd, data_axis, axes)
    y = _local(arr, mesh, placements)
    for k in range(nd - 1, -1, -1):
        lv = lvls[k]
        if lv == 0:
            continue
        ax = arr.ndim - nd + k
        c = _unpack_sharded(y.movedim(ax, -1), shape[k], lv, mesh, axes[k])
        n, pad_fn = shape[k] // _axis_size(mesh, axes[k]), make_pad_fn(mesh, None, axes[k])
        if _use_local_kernels(backend):
            y = _local_idwt1d(c, wav, n, pad_fn, False)
        else:
            y = idwt1d(c, wav, n, backend=backend, pad_fn=pad_fn)
        y = y.movedim(-1, ax)
    return _global(y, mesh, placements)
