"""Spatially sharded wavelet packet transforms: counterpart of
``pdwt_tpu/parallel/packets.py`` on ``torch.distributed``.

``core.packets`` is one batched single-level transform a depth, the
``fan^j`` nodes of depth j stacked on one axis.  Sharded, each depth is one
single-level sharded transform (``sharded._local_dwt2d`` / ``_local_dwt1d``
/ ``_local_dwt3d`` on this rank's shard: the padded kernels 1p, 7p, 1p with
the depth products, with the ring halo), the node axis riding the
replicated batch: a depth costs the halo of one single-level transform
however many nodes it holds.  The children are stacked on the local
shards (no communication: the node axis is unsharded), the approximation
cast to the details' dtype under a bf16 tier, as JAX casts it.

Best basis needs no sharded form: ``core.packets.best_basis`` takes the
DTensor nodes (each depth's cost sums all-reduced, the DP on the host).
Reconstruction (:func:`wp_reconstruct`, :func:`iwp1d`,
:func:`iwp2d`, :func:`iwp3d`) is ``core.packets.wp_reconstruct`` on the
local shards with its single-level inverse (``inv1_fn=``) the ring-halo
local inverse (2p, 8p, the depth-bit regrouping's 2p and the depth ring).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..core.packets import Packets1D, Packets2D, Packets3D, _geom, _split
from ..core.packets import wp_reconstruct as _core_wp_reconstruct
from ..core.shapes import level_sizes
from ..filters import Wavelet
from . import sharded as S
from .halo import make_pad_fn


def _node_placements(sd: int, mesh, ndim: int, axes: dict):
    """The placements of a ``ndim``-rank tensor of ``sd`` spatial axes, as
    the sharded transforms place it (the node axis unsharded)."""
    if sd == 3:
        return S._placements3d(mesh, ndim, axes.get("data_axis"), axes.get("dep_axis"),
                               axes.get("row_axis"), axes.get("col_axis"))
    if sd == 2:
        return S._placements(mesh, ndim, axes.get("data_axis"), axes.get("row_axis"),
                             axes.get("col_axis"))
    return S._placements1d(mesh, ndim, axes.get("data_axis"), axes.get("col_axis"))


def _pad(mesh, axes: dict):
    return make_pad_fn(mesh, axes.get("row_axis"), axes.get("col_axis"), axes.get("dep_axis"))


_CORE_FWD = {1: "dwt1d", 2: "dwt2d", 3: "dwt3d"}
_CORE_INV = {1: "idwt1d", 2: "idwt2d", 3: "idwt3d"}


def _core_module(sd: int):
    from ..core import separable, separable3d
    return separable3d if sd == 3 else separable


def _level_fn(sd: int, local_fn, backend):
    """A depth's single-level forward: the local composition, or under a
    conv formulation the core transform with the ring ``pad_fn``."""
    if S._use_local_kernels(backend):
        return local_fn
    fwd = getattr(_core_module(sd), _CORE_FWD[sd])
    return lambda x, wav, lv, pad_fn, swt: fwd(x, wav, lv, backend=backend, pad_fn=pad_fn)


def _wp(container, sd: int, x, wav, levels, mesh, axes: dict, level_fn):
    xl = S._local(x, mesh, _node_placements(sd, mesh, x.ndim, axes))
    pad_fn = _pad(mesh, axes)
    nodes = [xl.unsqueeze(-sd - 1)]
    for _ in range(levels):
        c = level_fn(nodes[-1], wav, 1, pad_fn, False)
        dets = c.details[0] if sd > 1 else (c.details[0],)
        nodes.append(_split(c.approx, dets, sd))
    pl = _node_placements(sd, mesh, x.ndim + 1, axes)
    return container(tuple(S._global(t, mesh, pl) for t in nodes))


def wp2d(x, wav: Wavelet, levels: int, mesh, *, data_axis: Optional[str] = None,
         row_axis: Optional[str] = None, col_axis: Optional[str] = None,
         backend: Optional[str] = None) -> Packets2D:
    """Sharded full 2D packet decomposition of ``x`` (a DTensor, or a full
    tensor placed with the input sharding): one ring-halo single-level DWT
    a depth, the node axis the replicated batch.  Nodes are DTensors."""
    S._validate2d(tuple(x.shape), mesh, data_axis, row_axis, col_axis, levels, swt=False)
    axes = dict(data_axis=data_axis, row_axis=row_axis, col_axis=col_axis)
    return _wp(Packets2D, 2, x, wav, levels, mesh, axes, _level_fn(2, S._local_dwt2d, backend))


def wp1d(x, wav: Wavelet, levels: int, mesh, *, data_axis: Optional[str] = None,
         col_axis: Optional[str] = None, backend: Optional[str] = None) -> Packets1D:
    """Sharded full 1D packet decomposition over the trailing axis."""
    if col_axis is not None:
        S._check_div("signal", x.shape[-1], S._axis_size(mesh, col_axis), levels, swt=False)
    axes = dict(data_axis=data_axis, col_axis=col_axis)
    return _wp(Packets1D, 1, x, wav, levels, mesh, axes, _level_fn(1, S._local_dwt1d, backend))


def wp3d(x, wav: Wavelet, levels: int, mesh, *, data_axis: Optional[str] = None,
         dep_axis: Optional[str] = None, row_axis: Optional[str] = None,
         col_axis: Optional[str] = None, backend: Optional[str] = None) -> Packets3D:
    """Sharded full 3D packet decomposition (octree): a depth is one
    ring-halo single-level 3D DWT over (depth, row, col), each depth's
    nodes checked as the sharded ``dwt3d`` checks its input."""
    sizes = [level_sizes(n, levels) for n in x.shape[-3:]]
    for j in range(levels):
        S._validate3d(tuple(x.shape[:-3]) + (8 ** j,) + tuple(s[j] for s in sizes), mesh,
                      data_axis, dep_axis, row_axis, col_axis, 1, False)
    axes = dict(data_axis=data_axis, dep_axis=dep_axis, row_axis=row_axis, col_axis=col_axis)
    return _wp(Packets3D, 3, x, wav, levels, mesh, axes, _level_fn(3, S._local_dwt3d, backend))


def _local_inv1(sd: int, wav, pad_fn, backend=None):
    """The ring-halo single-level inverse on local shards: (coeffs, local
    out_shape) -> this rank's shard (the core inverse with the ring under a
    conv formulation)."""
    if not S._use_local_kernels(backend):
        inv = getattr(_core_module(sd), _CORE_INV[sd])
        if sd == 1:
            return lambda cfs, out: inv(cfs, wav, out[0], backend=backend, pad_fn=pad_fn)
        return lambda cfs, out: inv(cfs, wav, out, backend=backend, pad_fn=pad_fn)
    if sd == 3:
        return lambda cfs, out: S._local_idwt3d(cfs, wav, out, pad_fn, False)
    if sd == 2:
        return lambda cfs, out: S._local_idwt2d(cfs, wav, out, pad_fn, False)
    return lambda cfs, out: S._local_idwt1d(cfs, wav, out[0], pad_fn, False)


def _reconstruct_local(packets_l, leaves, wav, mesh, axes: dict, out_ndim: int, map_fn=None,
                       backend=None):
    """``core.packets.wp_reconstruct`` on local shards (their shapes give
    the local per-depth sizes); ``map_fn`` sees each leaf as a DTensor."""
    sd, _, _ = _geom(packets_l)
    pl = _node_placements(sd, mesh, out_ndim, axes)
    fn = None
    if map_fn is not None:
        def fn(v, j, i):
            return S._local(map_fn(S._global(v, mesh, pl), j, i), mesh, pl)
    y = _core_wp_reconstruct(packets_l, leaves, wav, map_fn=fn,
                             inv1_fn=_local_inv1(sd, wav, _pad(mesh, axes), backend))
    return S._global(y, mesh, pl)


def _axes_of(sd: int, data_axis, dep_axis, row_axis, col_axis) -> dict:
    if sd == 3:
        return dict(data_axis=data_axis, dep_axis=dep_axis, row_axis=row_axis, col_axis=col_axis)
    if sd == 2:
        return dict(data_axis=data_axis, row_axis=row_axis, col_axis=col_axis)
    return dict(data_axis=data_axis, col_axis=col_axis)


def wp_reconstruct(packets, leaves: Sequence[Tuple[int, int]], wav: Wavelet, mesh, *,
                   data_axis: Optional[str] = None, dep_axis: Optional[str] = None,
                   row_axis: Optional[str] = None, col_axis: Optional[str] = None,
                   backend: Optional[str] = None, map_fn=None):
    """Sharded pruned-tree reconstruction: the core cover walk with every
    batched single-level inverse replaced by its ring-halo sharded
    counterpart.  A DTensor sharded as the decomposition's input."""
    sd, _, _ = _geom(packets)
    axes = _axes_of(sd, data_axis, dep_axis, row_axis, col_axis)
    ndim = packets.nodes[0].ndim
    pl = _node_placements(sd, mesh, ndim, axes)
    local = type(packets)(tuple(None if t is None else S._local(t, mesh, pl)
                                for t in packets.nodes))
    return _reconstruct_local(local, leaves, wav, mesh, axes, ndim - 1, map_fn, backend)


def _iwp_full(container, fan: int, sd: int, leaf_nodes, wav, shape, mesh, axes: dict,
              backend=None):
    """The full-tree inverse: ``wp_reconstruct`` over the complete deepest
    cover; the root entry is a shape-only ``meta`` tensor (only its shape
    feeds the per-depth sizes), of this rank's local shape."""
    n_nodes = leaf_nodes.shape[-(sd + 1)]
    levels = int(round(math.log(n_nodes, fan)))
    if fan ** levels != n_nodes:
        raise ValueError(f"node axis {n_nodes} is not a power of {fan}")
    pl = _node_placements(sd, mesh, leaf_nodes.ndim, axes)
    leaf_l = S._local(leaf_nodes, mesh, pl)
    names = {3: ("dep_axis", "row_axis", "col_axis"), 2: ("row_axis", "col_axis"),
             1: ("col_axis",)}[sd]
    local_shape = tuple(n // S._axis_size(mesh, axes.get(a)) for n, a in zip(shape, names))
    root = torch.empty(tuple(leaf_l.shape[:-(sd + 1)]) + (1,) + local_shape, device="meta")
    pk = container((root,) + (None,) * (levels - 1) + (leaf_l,))
    leaves = [(levels, i) for i in range(n_nodes)]
    return _reconstruct_local(pk, leaves, wav, mesh, axes, leaf_nodes.ndim - 1, backend=backend)


def iwp1d(leaf_nodes, wav: Wavelet, length: int, mesh, *, data_axis: Optional[str] = None,
          col_axis: Optional[str] = None, backend: Optional[str] = None):
    """Sharded inverse of the full 1D packet decomposition from
    ``packets.nodes[-1]``."""
    return _iwp_full(Packets1D, 2, 1, leaf_nodes, wav, (length,), mesh,
                     dict(data_axis=data_axis, col_axis=col_axis), backend)


def iwp2d(leaf_nodes, wav: Wavelet, shape: Tuple[int, int], mesh, *,
          data_axis: Optional[str] = None, row_axis: Optional[str] = None,
          col_axis: Optional[str] = None, backend: Optional[str] = None):
    """Sharded inverse of the full 2D packet decomposition from
    ``packets.nodes[-1]``; ``shape`` the global (rows, cols)."""
    return _iwp_full(Packets2D, 4, 2, leaf_nodes, wav, shape, mesh,
                     dict(data_axis=data_axis, row_axis=row_axis, col_axis=col_axis), backend)


def iwp3d(leaf_nodes, wav: Wavelet, shape: Tuple[int, int, int], mesh, *,
          data_axis: Optional[str] = None, dep_axis: Optional[str] = None,
          row_axis: Optional[str] = None, col_axis: Optional[str] = None,
          backend: Optional[str] = None):
    """Sharded inverse of the full 3D packet decomposition."""
    return _iwp_full(Packets3D, 8, 3, leaf_nodes, wav, shape, mesh,
                     dict(data_axis=data_axis, dep_axis=dep_axis, row_axis=row_axis,
                          col_axis=col_axis), backend)
