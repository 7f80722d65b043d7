"""Spatially sharded starlet (isotropic a-trous) transform: counterpart of
``pdwt_tpu/parallel/isotropic.py`` on ``torch.distributed``.

The starlet is undecimated, so the sharding story is the SWT's: every
spatial axis may be sharded (size % n_shards == 0), the B3 smoothing's
periodic pad is the multi-hop ring halo exchange on a sharded axis
(``make_pad_fn``'s per-axis rings), and the detail planes come back with
the input's sharding, equal to the single-device
:func:`pdwt_tpu_torch.core.starlet.starlet`.  Each rank runs
``core/starlet.py`` on its shard with that ``pad_fn``: conv passes, no
kernel, as JAX's ``backend="fma"`` runs them.
"""
from __future__ import annotations

import importlib
from typing import Optional, Tuple

from .halo import make_pad_fn
from .sharded import _axis_size, _global, _local

# ``core.starlet`` is the function (as in the JAX package), not the module
_core = importlib.import_module("..core.starlet", __package__)
StarletCoeffs = _core.StarletCoeffs


def _placements(mesh, x_ndim: int, sd: int, data_axis, spatial_axes):
    """JAX's ``_spec``: Shard(0) on ``data_axis``, the trailing ``sd`` dims
    on their named mesh axes, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    if data_axis is not None:
        dims[data_axis] = 0
    for i, name in enumerate(spatial_axes):
        if name is not None:
            dims[name] = x_ndim - sd + i
    return tuple(Shard(dims[n]) if n in dims else Replicate() for n in mesh.mesh_dim_names)


def _pad_fn(mesh, sd: int, spatial_axes):
    # make_pad_fn names the trailing conv dims (col -1, row -2, dep -3); in
    # 1D the core adds dummy axes, so the one spatial axis is the lane (-1)
    names = list(spatial_axes)
    return make_pad_fn(mesh, row_axis=names[-2] if sd >= 2 else None, col_axis=names[-1],
                       dep_axis=names[-3] if sd == 3 else None)


def _validate(x, mesh, sd: int, data_axis, spatial_axes) -> None:
    if len(spatial_axes) != sd:
        raise ValueError(f"need {sd} spatial axis names, got {len(spatial_axes)}")
    for i, name in enumerate(spatial_axes):
        if name is None:
            continue
        n = x.shape[x.ndim - sd + i]
        shards = _axis_size(mesh, name)
        if n % shards:
            raise ValueError(f"spatial axis {i} (size {n}) not divisible by {shards} shards on "
                             f"mesh axis {name!r}")
    if data_axis is not None and x.shape[0] % _axis_size(mesh, data_axis):
        raise ValueError("batch axis not divisible by data shards")


def starlet(x, levels: int, mesh, *, data_axis: Optional[str] = None,
            spatial_axes: Tuple[Optional[str], ...] = (None, None), gen: int = 2,
            backend: Optional[str] = None):
    """Sharded isotropic a-trous decomposition of ``x`` (a DTensor, or a
    full tensor placed with the input sharding); ``spatial_axes`` names the
    mesh axis (or None) per trailing spatial dim.  A ``StarletCoeffs`` of
    DTensors sharded as the input.  ``backend``: the passes' formulation
    (``None`` and ``"pallas"`` take ``"fma"``, as JAX's sharded starlet
    does)."""
    sd = len(spatial_axes)
    _validate(x, mesh, sd, data_axis, spatial_axes)
    placements = _placements(mesh, x.ndim, sd, data_axis, spatial_axes)
    c = _core.starlet(_local(x, mesh, placements), levels, ndim=sd, gen=gen,
                      backend=backend, pad_fn=_pad_fn(mesh, sd, spatial_axes))
    g = lambda t: _global(t, mesh, placements)
    return StarletCoeffs(g(c.approx), tuple(map(g, c.details)))


def istarlet(coeffs, mesh, *, data_axis: Optional[str] = None,
             spatial_axes: Tuple[Optional[str], ...] = (None, None), gen: int = 2,
             backend: Optional[str] = None):
    """Sharded inverse of :func:`starlet` (the same axes and ``gen``)."""
    sd = len(spatial_axes)
    a = coeffs.approx
    _validate(a, mesh, sd, data_axis, spatial_axes)
    placements = _placements(mesh, a.ndim, sd, data_axis, spatial_axes)
    loc = lambda t: _local(t, mesh, placements)
    cl = StarletCoeffs(loc(a), tuple(map(loc, coeffs.details)))
    return _global(_core.istarlet(cl, ndim=sd, gen=gen, backend=backend,
                                  pad_fn=_pad_fn(mesh, sd, spatial_axes)), mesh, placements)
