"""Sharded 2D, batched 1D, 3D and non-separable wavelet transforms over a
(data, row, col) device mesh, or (data, dep, row, col) for volumes:
counterpart of ``pdwt_tpu/parallel/sharded.py`` on ``torch.distributed``.

Inputs and outputs are ``DTensor``s, the counterpart of JAX's globally
sharded arrays (:func:`shard_image` places a tensor).  Each entry point runs
the local composition on every rank's shard (``to_local()``) and wraps each
band back with ``DTensor.from_local``, its global shape given.  The batch
is sharded over ``data_axis``; the rows and columns of an image over
``row_axis`` and ``col_axis``, the samples of a signal over ``col_axis``.

Every level exchanges the periodic halo its filter window needs with the
ring neighbours (``parallel/halo.py``) and runs on the local shard, JAX's
local Pallas composition (``sharded.py:101-349, 441-615``) whatever the
device.  The route of each level is decided before it runs, from the
shard's geometry, as JAX's per-level dispatch decides it:

* in an MXU mode (``mxu_mode`` for the decimated transforms: a bf16
  input, or float32 under ``mixed``; ``_swt_mxu_mode`` for the stationary
  ones, which run ``mixed`` exact), a level whose shard the route rule
  accepts (``kernels.mxu_route_2d``, ``mxu_route_swt_2d``,
  ``mxu_route_1d``: JAX's ``_pick_*_tiles`` gates on the local shard)
  runs the padded entry point of its banded-product kernel (decimated 2D:
  11 and 12; a-trous 2D: 13 and 14; batched 1D: 15 and 16) in the scheme
  of ``kernels.matmul``'s rules (``mode_scheme``, ``inv_plan``,
  ``swt_scheme``, ``swt2d_inv_plan``, ``mxu1d._swt_inv_plan``), its halo
  exchanged in the dtype the level reads (bf16 halos for a bf16 level);
* every other level runs float32: the padded entry points of the exact
  kernels (decimated 2D: 1 and 2; a-trous 2D: 5 and 6; decimated 1D: 7
  and 8; a-trous 1D: 9 and 10) with an even filter, the conv passes with
  the ring ``pad_fn`` otherwise (an odd filter, float64 on the CPU; JAX's
  own route, ``sharded.py:125-131, 247-256``), its inputs cast to float32
  in an MXU mode and its outputs cast as JAX casts them (bf16 details
  forward, bf16 at the last inverse level under bf16).

The entry points launch their CUDA kernels on a CUDA shard and run their
plain versions on a CPU shard; no level falls back to another route, and
a refused launch raises.  The decimated pads are the periodization
branches of ``core/separable.py: fwd_mode_pad`` and ``inv_mode_pad`` with
the ring in place of ``wrap_pad``; the a-trous halos are the bare
periodic support (``kernels.swt_fwd_halo``, ``swt_inv_halo``), not JAX's
Mosaic margins.  An odd size on an unsharded axis is extended as on one
card (its decimated forward level runs float32, as JAX's does).

A decimated transform needs every sharded size divisible by ``n_shards *
2^levels`` (each shard's sizes stay even at every level and the stride-2
phase is the same on every shard), the SWT by ``n_shards``; both raise
JAX's errors before any exchange.  Since the route rule sees the shard,
a level may take the banded-product kernel on one card and not on the
shards (a 1024² shard's level 4 has 64-wide subbands): the sharded tiers
match the single card within the tier's tolerance, as JAX's do.

A volume's level is the 2D level above on (B*D, r, c), depth as the
batch, then the depth pass of each subband over the depth ring
(``core/depth_matmul.py: depth_analysis_ring``); its inverse is always the
depth-bit regrouping (two 2D inverses a level, then
``depth_synthesis_ring``), as JAX's sharded inverse is, so it matches the
single-card exact inverse (depth synthesis first) to roundoff.  The
non-separable transforms run ``core/nonseparable.py`` on each shard with
the ring ``pad_fn``, or with none where only the batch is sharded.

``backend=`` (JAX's ``_use_local_pallas``, ``sharded.py:91-94``): ``None``
or ``"pallas"`` takes the local composition above, JAX's TPU route, on
every device; ``"fma"``, ``"xla"`` or ``"gather"`` runs the core
transform of that formulation on each shard with the ring ``pad_fn``
(``core/separable.py``'s conv route, no kernel), as JAX's conv route
does.  The composition's own conv-pass levels keep ``"fma"``, as JAX's
hard-code it (``sharded.py:128-129, 173-175, 257``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import kernels
from ..core import conv
from ..core import separable as sep_core
from ..core import separable3d as sep3
from ..core.depth_matmul import depth_analysis_ring, depth_synthesis_ring
from ..core.separable import (BF16, F32, Coeffs1D, Coeffs2D, _swt_mxu_mode, check_supported,
                              fwd_mode_pad, inv_mode_pad, mxu_mode)
from ..core.separable3d import Coeffs3D, depth_split, inv_level_regrouped
from ..core.shapes import level_sizes
from ..filters import Wavelet
from ..kernels.matmul import inv_plan, mode_out_dtypes, mode_scheme, swt_scheme
from ..kernels.mxu1d import _swt_inv_plan
from ..kernels.swt_matmul import swt2d_inv_plan
from .halo import make_pad_fn

PER = "periodization"


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _use_local_kernels(backend: Optional[str]) -> bool:
    """JAX's ``_use_local_pallas`` on the TPU: ``None`` or ``"pallas"``
    takes the local composition; a conv formulation the core transform
    with the ring ``pad_fn``."""
    return backend in (None, "pallas")


def _check_div(name: str, size: int, shards: int, levels: int, swt: bool):
    need = shards * (1 if swt else (1 << levels))
    if size % need != 0:
        kind = "n_shards" if swt else "n_shards * 2^levels"
        raise ValueError(
            f"sharded {name} size {size} must be divisible by {kind} = {need} "
            f"({shards} shards, {levels} levels)")


def _axis_size(mesh, axis: Optional[str]) -> int:
    if axis is None:
        return 1
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {names}")
    return mesh.shape[names.index(axis)]


def _validate2d(shape, mesh, data_axis, row_axis, col_axis, levels, swt):
    if len(shape) < 2:
        raise ValueError(f"expected at least a 2D array, got shape {tuple(shape)}")
    if data_axis is not None:
        if len(shape) < 3:
            raise ValueError("data_axis given but input has no batch dim")
        n = _axis_size(mesh, data_axis)
        if shape[0] % n != 0:
            raise ValueError(f"batch {shape[0]} not divisible by mesh axis {data_axis!r} ({n})")
    if row_axis is not None:
        _check_div("row", shape[-2], _axis_size(mesh, row_axis), levels, swt)
    if col_axis is not None:
        _check_div("col", shape[-1], _axis_size(mesh, col_axis), levels, swt)


# ---------------------------------------------------------------------------
# placement: DTensors <-> local shards
# ---------------------------------------------------------------------------

def _placements(mesh, ndim: int, data_axis, row_axis, col_axis, dep_axis=None):
    """Shard(0) on ``data_axis`` (input rank above 2, or above 1 with no
    row axis: a batch of signals; above 3 for a volume), Shard(ndim - 3) on
    ``dep_axis``, Shard(ndim - 2) on ``row_axis``, Shard(ndim - 1) on
    ``col_axis``, Replicate on every other mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {data_axis: 0, dep_axis: ndim - 3, row_axis: ndim - 2, col_axis: ndim - 1}
    return tuple(Shard(dims[n]) if n is not None and n in dims else Replicate()
                 for n in mesh.mesh_dim_names)


def _local(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``t``: a DTensor's local tensor (redistributed
    first where it is placed otherwise), or the slice of a full tensor
    that :func:`shard_image` would place here."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(t, DTensor):
        if tuple(t.placements) != tuple(placements):
            t = t.redistribute(mesh, placements)
        return t.to_local()
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            t = torch.chunk(t, mesh.shape[i], dim=p.dim)[coord[i]]
    return t.contiguous()


def _global(t: torch.Tensor, mesh, placements):
    """``t``, this rank's shard, as a DTensor of the global shape its
    placements give (each sharded size times its mesh axis)."""
    from torch.distributed.tensor import DTensor, Shard

    shape = list(t.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.shape[i]
    stride, acc = [0] * len(shape), 1
    for d in range(len(shape) - 1, -1, -1):
        stride[d], acc = acc, acc * shape[d]
    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def shard_image(x: torch.Tensor, mesh, *, data_axis: Optional[str] = None,
                row_axis: Optional[str] = None, col_axis: Optional[str] = None,
                dep_axis: Optional[str] = None):
    """Place a full tensor on the mesh with the transforms' input sharding:
    ``Shard`` on the named mesh axes (the batch over ``data_axis``, the rows
    and columns of a 2D input, or the samples of a 1D one, over
    ``row_axis`` / ``col_axis``; with ``dep_axis`` the input is a volume,
    its depth over ``dep_axis`` and its batch, if it has one, over
    ``data_axis``), ``Replicate`` elsewhere.  A 3D tensor without
    ``dep_axis`` is a batch of 2D images, as :func:`dwt2d` takes it.  What
    ``distribute_tensor(x, mesh, placements, src_data_rank=None)`` gives:
    every rank passes the same full tensor, as every process of JAX's
    program does, and keeps its own slice, with no communication."""
    if dep_axis is not None:
        placements = _placements3d(mesh, x.ndim, data_axis, dep_axis, row_axis, col_axis)
        return _global(_local(x, mesh, placements), mesh, placements)
    if x.ndim < 2:
        if data_axis is not None:
            raise ValueError("data_axis given but input has no batch dim")
        row_axis = None
    placements = _placements(mesh, x.ndim, data_axis, row_axis, col_axis)
    return _global(_local(x, mesh, placements), mesh, placements)


def all_reduce_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` summed over the ranks of each named mesh axis (None skipped)
    with ``dist.all_reduce``: equal on every rank.  A gloo group sums a
    card tensor through host memory."""
    import torch.distributed as dist

    for axis in axes:
        if axis is None or _axis_size(mesh, axis) == 1:
            continue
        group = mesh.get_group(axis)
        host = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
        s = t.detach().cpu().clone() if host else t.detach().clone()
        dist.all_reduce(s, group=group)
        t = s.to(t.device) if host else s
    return t


def _flat(t: torch.Tensor, k: int) -> torch.Tensor:
    """(B, trailing k axes), the leading axes flattened."""
    return t.reshape((-1,) + tuple(t.shape[t.ndim - k:])).contiguous()


# ---------------------------------------------------------------------------
# one level of each local composition
# ---------------------------------------------------------------------------

def _padded_route(a: torch.Tensor, wav: Wavelet) -> bool:
    """float32 with an even filter: the padded kernel entry points; else
    the conv passes with the ring pad_fn (JAX's route either way)."""
    check_supported(a)
    return a.dtype == torch.float32 and wav.hlen % 2 == 0


def _norm(mode: Optional[str], a, *dets):
    """A forward level's outputs in an MXU mode's dtypes (JAX's
    ``_norm_mxu_out``): under bf16 a float32 approximation and bf16
    details; as they are otherwise."""
    if mode == "bf16":
        return (a.float(), *(t.to(BF16) for t in dets))
    return (a, *dets)


def _fwd_level_2d_local(a, wav, mode, pad_fn):
    """One decimated 2D level on (B, r, c) -> the raw four subbands: in an
    MXU mode, kernel 11's padded entry point where the route rule accepts
    the shard's even (r, c); else the float32 padded kernel 1 (or the conv
    passes), its outputs cast as JAX casts them."""
    dec, hlen = (wav.dec_lo, wav.dec_hi), wav.hlen
    r, c = a.shape[-2:]
    if mode and r % 2 == 0 and c % 2 == 0 and kernels.mxu_route_2d(r // 2, c // 2, hlen):
        xp = fwd_mode_pad(fwd_mode_pad(a, -1, hlen, PER, pad_fn), -2, hlen, PER, pad_fn)
        return kernels.fwd_level_2d_mxu_padded(xp.contiguous(), *dec, mode_scheme(mode, a.dtype),
                                               mode_out_dtypes(mode))
    a = a.float() if mode else a
    if _padded_route(a, wav):
        xp = fwd_mode_pad(fwd_mode_pad(a, -1, hlen, PER, pad_fn), -2, hlen, PER, pad_fn)
        return _norm(mode, *kernels.fwd_level_2d_padded(xp.contiguous(), *dec))
    z = conv.analysis_pass(a[:, None], dec, axis=-1, pad_fn=pad_fn)
    z = conv.analysis_pass(z, dec, axis=-2, pad_fn=pad_fn)
    return _norm(mode, *(z[:, k] for k in range(4)))


def _inv_pad2(t, hlen, out_rc, pad_fn):
    """A decimated inverse level's band with its periodic halo on both
    axes, and the offsets c0 of its padded synthesis."""
    t, c_r = inv_mode_pad(t, -2, hlen, PER, out_rc[0], pad_fn)
    t, c_c = inv_mode_pad(t, -1, hlen, PER, out_rc[1], pad_fn)
    return t.contiguous(), (c_r, c_c)


def _inv_level_2d_local(a, h, v, d, wav, mode, out_dt, pad_fn, out_rc):
    """One decimated 2D inverse level on (B, mr, mc) subbands -> (B,
    *out_rc): 2m, or 2m - 1 on an odd unsharded axis.  In an MXU mode,
    kernel 12's padded entry point where the route rule accepts the
    shard's (mr, mc), in the scheme of ``inv_plan`` for ``out_dt``; else
    the float32 route, cast to ``out_dt``."""
    rec, hlen = (wav.rec_lo, wav.rec_hi), wav.hlen
    if mode and kernels.mxu_route_2d(a.shape[-2], a.shape[-1], hlen):
        scheme, out_dt = inv_plan(mode, out_dt)
        dets = [t.float() for t in (h, v, d)] if mode == "mixed" else [h, v, d]
        padded = [_inv_pad2(t, hlen, out_rc, pad_fn) for t in (a.float(), *dets)]
        return kernels.inv_level_2d_mxu_padded(*(t for t, _ in padded), *rec, scheme,
                                               padded[0][1], tuple(out_rc), out_dt)
    if mode:
        a, h, v, d = (t.float() for t in (a, h, v, d))
    if _padded_route(a, wav):
        padded = [_inv_pad2(t, hlen, out_rc, pad_fn) for t in (a, h, v, d)]
        y = kernels.inv_level_2d_padded(*(t for t, _ in padded), *rec, padded[0][1],
                                        tuple(out_rc))
    else:
        z = torch.stack([a, h, v, d], 1)
        t = conv.synthesis_pass(z, rec, axis=-2, out_len=out_rc[0], pad_fn=pad_fn)
        y = conv.synthesis_pass(t, rec, axis=-1, out_len=out_rc[1], pad_fn=pad_fn)[:, 0]
    return y.to(out_dt) if mode else y


def _pad2(t, lohi, pad_fn):
    lo, hi = lohi
    return pad_fn(pad_fn(t, -1, lo, hi), -2, lo, hi).contiguous()


def _swt_fwd_level_2d_local(a, wav, lvl, mode, pad_fn):
    """One a-trous 2D level on (B, r, c) -> the raw four subbands: in a bf16
    mode, kernel 13's padded entry point where the route rule accepts the
    shard at this level; else the float32 padded kernel 5 (or the conv
    passes), cast as JAX casts."""
    dec = (wav.dec_lo, wav.dec_hi)
    if mode and kernels.mxu_route_swt_2d(a.shape[-2], a.shape[-1], wav.hlen, lvl):
        return kernels.swt_fwd_level_2d_mxu_padded(
            _pad2(a, kernels.swt_fwd_halo(wav.hlen, lvl), pad_fn), *dec, lvl,
            swt_scheme(mode, a.dtype), mode_out_dtypes(mode))
    a = a.float() if mode else a
    if _padded_route(a, wav):
        return _norm(mode, *kernels.swt_fwd_level_2d_padded(
            _pad2(a, kernels.swt_fwd_halo(wav.hlen, lvl), pad_fn), *dec, lvl))
    f = 1 << (lvl - 1)
    z = conv.analysis_pass(a[:, None], dec, axis=-1, dilation=f, decimate=False, pad_fn=pad_fn)
    z = conv.analysis_pass(z, dec, axis=-2, dilation=f, decimate=False, pad_fn=pad_fn)
    return _norm(mode, *(z[:, k] for k in range(4)))


def _swt_inv_level_2d_local(a, h, v, d, wav, lvl, mode, out_dt, pad_fn):
    """One a-trous 2D inverse level on (B, r, c) subbands (the 1/2 per
    pass in the taps): in a bf16 mode, kernel 14's padded entry point where
    the route rule accepts the shard (``swt2d_inv_plan``'s scheme); else
    the float32 route, cast to ``out_dt``."""
    halo = kernels.swt_inv_halo(wav.hlen, lvl)
    if mode and kernels.mxu_route_swt_2d(a.shape[-2], a.shape[-1], wav.hlen, lvl):
        scheme, out_dt = swt2d_inv_plan(mode, out_dt)
        return kernels.swt_inv_level_2d_mxu_padded(
            *(_pad2(t, halo, pad_fn) for t in (a.float(), h, v, d)), wav.rec_lo, wav.rec_hi, lvl,
            scheme, out_dt)
    if mode:
        a, h, v, d = (t.float() for t in (a, h, v, d))
    if _padded_route(a, wav):
        y = kernels.swt_inv_level_2d_padded(*(_pad2(t, halo, pad_fn) for t in (a, h, v, d)),
                                            wav.rec_lo, wav.rec_hi, lvl)
    else:
        f = 1 << (lvl - 1)
        rec = (wav.rec_lo * 0.5, wav.rec_hi * 0.5)
        z = torch.stack([a, h, v, d], 1)
        t = conv.synthesis_pass(z, rec, axis=-2, dilation=f, decimated=False, pad_fn=pad_fn)
        y = conv.synthesis_pass(t, rec, axis=-1, dilation=f, decimated=False,
                                pad_fn=pad_fn)[:, 0]
    return y.to(out_dt) if mode else y


# ---------------------------------------------------------------------------
# the local compositions: 2D
# ---------------------------------------------------------------------------

def _mode(dtype: torch.dtype, swt: bool) -> Optional[str]:
    """The MXU mode of a composition: ``mxu_mode`` for the decimated
    transforms; ``mixed`` runs the stationary ones exact
    (``_swt_mxu_mode``), as JAX does."""
    return _swt_mxu_mode(dtype) if swt else mxu_mode(dtype)


def _local_dwt2d(xl, wav, levels, pad_fn, swt, exact=False):
    """The local 2D forward composition; ``exact`` runs no MXU mode, every
    level in the input's dtype (the ring route of the non-separable
    transforms, as JAX's conv backends run it)."""
    batch = tuple(xl.shape[:-2])
    mode = None if exact else _mode(xl.dtype, swt)
    a = _flat(xl, 2)
    details = []
    for lvl in range(1, levels + 1):
        if swt:
            a, h, v, d = _swt_fwd_level_2d_local(a, wav, lvl, mode, pad_fn)
        else:
            a, h, v, d = _fwd_level_2d_local(a, wav, mode, pad_fn)
        details.append(tuple(t.reshape(batch + tuple(t.shape[1:])) for t in (h, v, d)))
    return Coeffs2D(a.reshape(batch + tuple(a.shape[1:])), tuple(details))


def _local_idwt2d(cl, wav, local_shape, pad_fn, swt, exact=False):
    levels = cl.levels
    batch = tuple(cl.approx.shape[:-2])
    mode = None if exact else _mode(cl.details[-1][0].dtype if levels else cl.approx.dtype,
                                    swt)
    rows = level_sizes(local_shape[0], levels)
    cols = level_sizes(local_shape[1], levels)
    a = _flat(cl.approx, 2)
    a = a.float() if mode == "bf16" else a
    for i in range(levels - 1, -1, -1):
        h, v, d = (_flat(t, 2) for t in cl.details[i])
        out_dt = BF16 if mode == "bf16" and i == 0 else F32
        if swt:
            a = _swt_inv_level_2d_local(a, h, v, d, wav, i + 1, mode, out_dt, pad_fn)
        else:
            a = _inv_level_2d_local(a, h, v, d, wav, mode, out_dt, pad_fn, (rows[i], cols[i]))
    return a.reshape(batch + tuple(a.shape[1:]))


def dwt2d(x, wav: Wavelet, levels: int, mesh, *, data_axis: Optional[str] = None,
          row_axis: Optional[str] = None, col_axis: Optional[str] = None,
          backend: Optional[str] = None, swt: bool = False) -> Coeffs2D:
    """Sharded multi-level separable 2D DWT (or SWT with ``swt=True``) of
    ``x``, a DTensor (or a full tensor, placed by :func:`shard_image`)
    -> a ``Coeffs2D`` of DTensors sharded as the input."""
    _validate2d(tuple(x.shape), mesh, data_axis, row_axis, col_axis, levels, swt)
    placements = _placements(mesh, x.ndim, data_axis, row_axis, col_axis)
    pad_fn = make_pad_fn(mesh, row_axis, col_axis)
    xl = _local(x, mesh, placements)
    if _use_local_kernels(backend):
        cl = _local_dwt2d(xl, wav, levels, pad_fn, swt)
    else:
        core = sep_core.swt2d if swt else sep_core.dwt2d
        cl = core(xl, wav, levels, backend=backend, pad_fn=pad_fn)
    g = lambda t: _global(t, mesh, placements)
    return Coeffs2D(g(cl.approx), tuple(tuple(map(g, band)) for band in cl.details))


def idwt2d(coeffs: Coeffs2D, wav: Wavelet, shape: Tuple[int, int], mesh, *,
           data_axis: Optional[str] = None, row_axis: Optional[str] = None,
           col_axis: Optional[str] = None, backend: Optional[str] = None, swt: bool = False):
    """Sharded inverse of :func:`dwt2d`; ``shape`` is the global (Nr, Nc).
    Returns a DTensor sharded as the forward's input."""
    levels = coeffs.levels
    a = coeffs.approx
    _validate2d(tuple(a.shape), mesh, data_axis, None, None, levels, swt)
    if row_axis is not None:
        _check_div("row", shape[0], _axis_size(mesh, row_axis), levels, swt)
    if col_axis is not None:
        _check_div("col", shape[1], _axis_size(mesh, col_axis), levels, swt)
    placements = _placements(mesh, a.ndim, data_axis, row_axis, col_axis)
    pad_fn = make_pad_fn(mesh, row_axis, col_axis)
    local_shape = (shape[0] // _axis_size(mesh, row_axis), shape[1] // _axis_size(mesh, col_axis))
    loc = lambda t: _local(t, mesh, placements)
    cl = Coeffs2D(loc(a), tuple(tuple(map(loc, band)) for band in coeffs.details))
    if _use_local_kernels(backend):
        y = _local_idwt2d(cl, wav, local_shape, pad_fn, swt)
    elif swt:
        y = sep_core.iswt2d(cl, wav, backend=backend, pad_fn=pad_fn)
    else:
        y = sep_core.idwt2d(cl, wav, local_shape, backend=backend, pad_fn=pad_fn)
    return _global(y, mesh, placements)


def swt2d(x, wav, levels, mesh, **kw) -> Coeffs2D:
    return dwt2d(x, wav, levels, mesh, swt=True, **kw)


def iswt2d(coeffs, wav, shape, mesh, **kw):
    return idwt2d(coeffs, wav, shape, mesh, swt=True, **kw)


# ---------------------------------------------------------------------------
# the local compositions: batched 1D, the batch over data_axis, the
# samples over col_axis
# ---------------------------------------------------------------------------

def _fwd_level_1d_local(a, wav, lvl, mode, pad_fn, swt):
    """One batched 1D analysis level (decimated, or a-trous at ``lvl``) on
    (B, n) -> (lo, hi): in an MXU mode, kernel 15's padded entry point where
    the route rule accepts the shard; else the float32 padded kernel 7 or 9
    (or the conv pass), cast as JAX casts."""
    dec, hlen = (wav.dec_lo, wav.dec_hi), wav.hlen
    B, n = a.shape
    if mode and kernels.mxu_route_1d(B, n, hlen, level=lvl if swt else None):
        scheme, hi_dt = ((swt_scheme if swt else mode_scheme)(mode, a.dtype),
                         mode_out_dtypes(mode)[1])
        if swt:
            lo, hi = kernels.swt_fwd_halo(hlen, lvl)
            return kernels.swt_fwd_level_1d_mxu_padded(pad_fn(a, -1, lo, hi).contiguous(), *dec,
                                                       lvl, scheme, hi_dt)
        return kernels.fwd_level_1d_mxu_padded(
            fwd_mode_pad(a, -1, hlen, PER, pad_fn).contiguous(), *dec, scheme, hi_dt)
    a = a.float() if mode else a
    if _padded_route(a, wav):
        if swt:
            lo, hi = kernels.swt_fwd_halo(hlen, lvl)
            res = kernels.swt_fwd_level_1d_padded(pad_fn(a, -1, lo, hi).contiguous(), *dec, lvl)
        else:
            res = kernels.fwd_level_1d_padded(fwd_mode_pad(a, -1, hlen, PER, pad_fn).contiguous(),
                                              *dec)
    else:
        z = conv.analysis_pass(a[:, None, None], dec, axis=-1,
                               dilation=1 << (lvl - 1) if swt else 1, decimate=not swt,
                               pad_fn=pad_fn)
        res = (z[:, 0, 0], z[:, 1, 0])
    return _norm(mode, *res)


def _inv_level_1d_local(a, d, wav, lvl, mode, out_dt, pad_fn, out_len, swt):
    """One batched 1D synthesis level (polyphase into ``out_len`` samples,
    or a-trous at ``lvl``) on two (B, m) bands: in an MXU mode, kernel
    16's padded entry point where the route rule accepts the shard; else
    the float32 route, cast to ``out_dt``."""
    rec, hlen = (wav.rec_lo, wav.rec_hi), wav.hlen
    B, m = a.shape
    if mode and kernels.mxu_route_1d(B, m if swt else 2 * m, hlen, level=lvl if swt else None):
        scheme, out_dt = (_swt_inv_plan if swt else inv_plan)(mode, out_dt)
        d = d.float() if mode == "mixed" else d
        if swt:
            lo, hi = kernels.swt_inv_halo(hlen, lvl)
            return kernels.swt_inv_level_1d_mxu_padded(
                *(pad_fn(t, -1, lo, hi).contiguous() for t in (a.float(), d)), *rec, lvl, scheme,
                out_dt)
        (ap, c0), (dp, _) = (inv_mode_pad(t, -1, hlen, PER, out_len, pad_fn)
                             for t in (a.float(), d))
        return kernels.inv_level_1d_mxu_padded(ap.contiguous(), dp.contiguous(), *rec, scheme,
                                               c0, out_len, out_dt)
    if mode:
        a, d = a.float(), d.float()
    if _padded_route(a, wav):
        if swt:
            lo, hi = kernels.swt_inv_halo(hlen, lvl)
            y = kernels.swt_inv_level_1d_padded(*(pad_fn(t, -1, lo, hi).contiguous()
                                                  for t in (a, d)), *rec, lvl)
        else:
            (ap, c0), (dp, _) = (inv_mode_pad(t, -1, hlen, PER, out_len, pad_fn) for t in (a, d))
            y = kernels.inv_level_1d_padded(ap.contiguous(), dp.contiguous(), *rec, c0, out_len)
    else:
        z = torch.stack([a, d], 1)[:, :, None]
        if swt:
            half = (wav.rec_lo * 0.5, wav.rec_hi * 0.5)
            y = conv.synthesis_pass(z, half, axis=-1, dilation=1 << (lvl - 1), decimated=False,
                                    pad_fn=pad_fn)[:, 0, 0]
        else:
            y = conv.synthesis_pass(z, rec, axis=-1, out_len=out_len, pad_fn=pad_fn)[:, 0, 0]
    return y.to(out_dt) if mode else y


def _local_dwt1d(xl, wav, levels, pad_fn, swt):
    batch = tuple(xl.shape[:-1])
    mode = _mode(xl.dtype, swt)
    a = _flat(xl, 1)
    details = []
    for lvl in range(1, levels + 1):
        a, d = _fwd_level_1d_local(a, wav, lvl, mode, pad_fn, swt)
        details.append(d.reshape(batch + tuple(d.shape[1:])))
    return Coeffs1D(a.reshape(batch + tuple(a.shape[1:])), tuple(details))


def _local_idwt1d(cl, wav, local_len, pad_fn, swt):
    levels = cl.levels
    batch = tuple(cl.approx.shape[:-1])
    mode = _mode(cl.details[-1].dtype if levels else cl.approx.dtype, swt)
    sizes = level_sizes(local_len, levels)
    a = _flat(cl.approx, 1)
    a = a.float() if mode == "bf16" else a
    for i in range(levels - 1, -1, -1):
        out_dt = BF16 if mode == "bf16" and i == 0 else F32
        a = _inv_level_1d_local(a, _flat(cl.details[i], 1), wav, i + 1, mode, out_dt, pad_fn,
                                sizes[i], swt)
    return a.reshape(batch + tuple(a.shape[1:]))


def _placements1d(mesh, ndim, data_axis, col_axis):
    if data_axis is not None and ndim < 2:
        raise ValueError("data_axis given but input has no batch dim")
    return _placements(mesh, ndim, data_axis, None, col_axis)


def dwt1d(x, wav: Wavelet, levels: int, mesh, *, data_axis: Optional[str] = None,
          col_axis: Optional[str] = None, backend: Optional[str] = None,
          swt: bool = False) -> Coeffs1D:
    """Sharded multi-level 1D DWT (or SWT with ``swt=True``) along the last
    axis of ``x``, a DTensor or a full tensor -> a ``Coeffs1D`` of
    DTensors."""
    placements = _placements1d(mesh, x.ndim, data_axis, col_axis)
    if data_axis is not None and x.shape[0] % _axis_size(mesh, data_axis) != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by mesh axis {data_axis!r} "
                         f"({_axis_size(mesh, data_axis)})")
    if col_axis is not None:
        _check_div("signal", x.shape[-1], _axis_size(mesh, col_axis), levels, swt)
    pad_fn = make_pad_fn(mesh, None, col_axis)
    xl = _local(x, mesh, placements)
    if _use_local_kernels(backend):
        cl = _local_dwt1d(xl, wav, levels, pad_fn, swt)
    else:
        core = sep_core.swt1d if swt else sep_core.dwt1d
        cl = core(xl, wav, levels, backend=backend, pad_fn=pad_fn)
    g = lambda t: _global(t, mesh, placements)
    return Coeffs1D(g(cl.approx), tuple(map(g, cl.details)))


def idwt1d(coeffs: Coeffs1D, wav: Wavelet, length: int, mesh, *,
           data_axis: Optional[str] = None, col_axis: Optional[str] = None,
           backend: Optional[str] = None, swt: bool = False):
    """Sharded inverse of :func:`dwt1d`; ``length`` is the global signal
    length."""
    levels = coeffs.levels
    a = coeffs.approx
    if col_axis is not None:
        _check_div("signal", length, _axis_size(mesh, col_axis), levels, swt)
    placements = _placements1d(mesh, a.ndim, data_axis, col_axis)
    pad_fn = make_pad_fn(mesh, None, col_axis)
    local_len = length // _axis_size(mesh, col_axis)
    loc = lambda t: _local(t, mesh, placements)
    cl = Coeffs1D(loc(a), tuple(map(loc, coeffs.details)))
    if _use_local_kernels(backend):
        y = _local_idwt1d(cl, wav, local_len, pad_fn, swt)
    elif swt:
        y = sep_core.iswt1d(cl, wav, backend=backend, pad_fn=pad_fn)
    else:
        y = sep_core.idwt1d(cl, wav, local_len, backend=backend, pad_fn=pad_fn)
    return _global(y, mesh, placements)


def swt1d(x, wav, levels, mesh, **kw) -> Coeffs1D:
    return dwt1d(x, wav, levels, mesh, swt=True, **kw)


def iswt1d(coeffs, wav, length, mesh, **kw):
    return idwt1d(coeffs, wav, length, mesh, swt=True, **kw)


# ---------------------------------------------------------------------------
# 3D: volumes sharded over (depth, row, col), JAX's sharded.py:687-912
# ---------------------------------------------------------------------------

def _placements3d(mesh, ndim, data_axis, dep_axis, row_axis, col_axis):
    """JAX's ``_spec3d``: the batch over ``data_axis`` where the volume has
    one, its depth, rows and columns over the other three."""
    return _placements(mesh, ndim, data_axis if ndim > 3 else None, row_axis, col_axis,
                       dep_axis)


def _validate3d(shape, mesh, data_axis, dep_axis, row_axis, col_axis, levels, swt):
    if len(shape) < 3:
        raise ValueError(f"expected at least a 3D array, got shape {tuple(shape)}")
    if data_axis is not None:
        if len(shape) < 4:
            raise ValueError("data_axis given but input has no batch dim")
        n = _axis_size(mesh, data_axis)
        if shape[0] % n != 0:
            raise ValueError(f"batch {shape[0]} not divisible by mesh axis {data_axis!r} ({n})")
    for name, ax, dim in (("depth", dep_axis, -3), ("row", row_axis, -2), ("col", col_axis, -1)):
        if ax is not None:
            _check_div(name, shape[dim], _axis_size(mesh, ax), levels, swt)


def _local_dwt3d(xl, wav, levels, pad_fn, swt):
    """Each level: the local 2D level on (B*D, r, c), depth as its batch
    (1p or 5p float32, 11p or 13p where the route rule accepts the shard
    under a tier, the conv passes with the ring otherwise), its outputs in
    the mode's dtypes, then the depth analysis of each subband over the
    depth ring (``depth_analysis_ring``)."""
    batch = tuple(xl.shape[:-3])
    mode = _mode(xl.dtype, swt)
    analysis = functools.partial(depth_analysis_ring, pad_fn=pad_fn)
    a = _flat(xl, 3)
    details = []
    for lvl in range(1, levels + 1):
        b, dd, r, c = a.shape
        flat = a.reshape(b * dd, r, c)
        if swt:
            res = _swt_fwd_level_2d_local(flat, wav, lvl, mode, pad_fn)
        else:
            res = _fwd_level_2d_local(flat, wav, mode, pad_fn)
        bands = depth_split(res, wav, b, dd, dilation=1 << (lvl - 1) if swt else 1,
                            decimate=not swt, mxu=mode, analysis=analysis)
        a = bands[0].contiguous()
        details.append(tuple(t.reshape(batch + tuple(t.shape[1:])) for t in bands[1:]))
    return Coeffs3D(a.reshape(batch + tuple(a.shape[1:])), tuple(details))


def _local_idwt3d(cl, wav, local_shape, pad_fn, swt):
    """Each level by the depth-bit regrouping, as JAX's sharded inverse
    (sharded.py:742-831): two local 2D inverses (2p/6p, 12p/14p where the
    route rule accepts the shard) writing float32, then the depth
    synthesis over the depth ring; in bf16 the last level is cast to bf16."""
    levels = cl.levels
    deps, rows, cols = (level_sizes(n, levels) for n in local_shape)
    batch = tuple(cl.approx.shape[:-3])
    mode = _mode(cl.details[-1][0].dtype if levels else cl.approx.dtype, swt)
    synthesis = functools.partial(depth_synthesis_ring, pad_fn=pad_fn)
    a = _flat(cl.approx, 3)
    a = a.float() if mode == "bf16" else a
    for i in range(levels - 1, -1, -1):
        if swt:
            inv2d = functools.partial(_swt_inv_level_2d_local, wav=wav, lvl=i + 1, mode=mode,
                                      out_dt=F32, pad_fn=pad_fn)
        else:
            inv2d = functools.partial(_inv_level_2d_local, wav=wav, mode=mode, out_dt=F32,
                                      pad_fn=pad_fn, out_rc=(rows[i], cols[i]))
        a = inv_level_regrouped(a, [_flat(t, 3) for t in cl.details[i]], inv2d, wav,
                                out_dep=deps[i], swt_level=i + 1 if swt else 0,
                                synthesis=synthesis)
        if mode:
            a = a.to(BF16 if mode == "bf16" and i == 0 else F32)
    return a.reshape(batch + tuple(a.shape[1:]))


def dwt3d(x, wav: Wavelet, levels: int, mesh, *, data_axis: Optional[str] = None,
          dep_axis: Optional[str] = None, row_axis: Optional[str] = None,
          col_axis: Optional[str] = None, backend: Optional[str] = None,
          swt: bool = False) -> Coeffs3D:
    """Sharded multi-level separable 3D DWT (or SWT with ``swt=True``) of
    ``x`` (..., D, R, C), a DTensor (or a full tensor, placed by
    :func:`shard_image` with ``dep_axis``) -> a ``Coeffs3D`` of DTensors
    sharded as the input."""
    _validate3d(tuple(x.shape), mesh, data_axis, dep_axis, row_axis, col_axis, levels, swt)
    placements = _placements3d(mesh, x.ndim, data_axis, dep_axis, row_axis, col_axis)
    pad_fn = make_pad_fn(mesh, row_axis, col_axis, dep_axis)
    xl = _local(x, mesh, placements)
    if _use_local_kernels(backend):
        cl = _local_dwt3d(xl, wav, levels, pad_fn, swt)
    else:
        core = sep3.swt3d if swt else sep3.dwt3d
        cl = core(xl, wav, levels, backend=backend, pad_fn=pad_fn)
    g = lambda t: _global(t, mesh, placements)
    return Coeffs3D(g(cl.approx), tuple(tuple(map(g, band)) for band in cl.details))


def idwt3d(coeffs: Coeffs3D, wav: Wavelet, shape: Tuple[int, int, int], mesh, *,
           data_axis: Optional[str] = None, dep_axis: Optional[str] = None,
           row_axis: Optional[str] = None, col_axis: Optional[str] = None,
           backend: Optional[str] = None, swt: bool = False):
    """Sharded inverse of :func:`dwt3d`; ``shape`` is the global (Nd, Nr,
    Nc).  Returns a DTensor sharded as the forward's input."""
    levels = coeffs.levels
    a = coeffs.approx
    _validate3d(tuple(a.shape), mesh, data_axis, None, None, None, levels, swt)
    axes = (dep_axis, row_axis, col_axis)
    for name, ax, n in zip(("depth", "row", "col"), axes, shape):
        if ax is not None:
            _check_div(name, n, _axis_size(mesh, ax), levels, swt)
    placements = _placements3d(mesh, a.ndim, data_axis, dep_axis, row_axis, col_axis)
    pad_fn = make_pad_fn(mesh, row_axis, col_axis, dep_axis)
    local_shape = tuple(n // _axis_size(mesh, ax) for n, ax in zip(shape, axes))
    loc = lambda t: _local(t, mesh, placements)
    cl = Coeffs3D(loc(a), tuple(tuple(map(loc, band)) for band in coeffs.details))
    if _use_local_kernels(backend):
        y = _local_idwt3d(cl, wav, local_shape, pad_fn, swt)
    elif swt:
        y = sep3.iswt3d(cl, wav, backend=backend, pad_fn=pad_fn)
    else:
        y = sep3.idwt3d(cl, wav, local_shape, backend=backend, pad_fn=pad_fn)
    return _global(y, mesh, placements)


def swt3d(x, wav, levels, mesh, **kw) -> Coeffs3D:
    return dwt3d(x, wav, levels, mesh, swt=True, **kw)


def iswt3d(coeffs, wav, shape, mesh, **kw):
    return idwt3d(coeffs, wav, shape, mesh, swt=True, **kw)


# ---------------------------------------------------------------------------
# non-separable (true 2D quads), JAX's sharded.py:934-1001
# ---------------------------------------------------------------------------

def _ns_pad_fn(mesh, row_axis, col_axis):
    """The ring where rows or columns are sharded; None where only the
    batch is, so that each shard is the single-card call (kernels 17-18 and
    the separable kernels stay on its route, as JAX's comment at
    sharded.py:949-952 says)."""
    if row_axis is None and col_axis is None:
        return None
    return make_pad_fn(mesh, row_axis, col_axis)


def dwt2d_ns(x, quads, levels: int, mesh, *, data_axis: Optional[str] = None,
             row_axis: Optional[str] = None, col_axis: Optional[str] = None,
             swt: bool = False) -> Coeffs2D:
    """Sharded non-separable 2D DWT (or SWT with ``swt=True``) with the
    forward quads ``quads``: ``core.nonseparable`` on each shard with the
    ring ``pad_fn``."""
    from ..core import nonseparable as ns

    _validate2d(tuple(x.shape), mesh, data_axis, row_axis, col_axis, levels, swt)
    placements = _placements(mesh, x.ndim, data_axis, row_axis, col_axis)
    core = ns.swt2d_ns if swt else ns.dwt2d_ns
    cl = core(_local(x, mesh, placements), quads, levels,
              pad_fn=_ns_pad_fn(mesh, row_axis, col_axis))
    g = lambda t: _global(t, mesh, placements)
    return Coeffs2D(g(cl.approx), tuple(tuple(map(g, band)) for band in cl.details))


def idwt2d_ns(coeffs: Coeffs2D, quads_inv, shape: Tuple[int, int], mesh, *,
              data_axis: Optional[str] = None, row_axis: Optional[str] = None,
              col_axis: Optional[str] = None, swt: bool = False):
    """Sharded inverse of :func:`dwt2d_ns` with the inverse quads
    ``quads_inv``; ``shape`` is the global (Nr, Nc)."""
    from ..core import nonseparable as ns

    levels = coeffs.levels
    a = coeffs.approx
    _validate2d(tuple(a.shape), mesh, data_axis, None, None, levels, swt)
    if row_axis is not None:
        _check_div("row", shape[0], _axis_size(mesh, row_axis), levels, swt)
    if col_axis is not None:
        _check_div("col", shape[1], _axis_size(mesh, col_axis), levels, swt)
    placements = _placements(mesh, a.ndim, data_axis, row_axis, col_axis)
    pad_fn = _ns_pad_fn(mesh, row_axis, col_axis)
    loc = lambda t: _local(t, mesh, placements)
    cl = Coeffs2D(loc(a), tuple(tuple(map(loc, band)) for band in coeffs.details))
    if swt:
        y = ns.iswt2d_ns(cl, quads_inv, pad_fn=pad_fn)
    else:
        local_shape = (shape[0] // _axis_size(mesh, row_axis),
                       shape[1] // _axis_size(mesh, col_axis))
        y = ns.idwt2d_ns(cl, quads_inv, local_shape, pad_fn=pad_fn)
    return _global(y, mesh, placements)


def swt2d_ns(x, quads, levels, mesh, **kw) -> Coeffs2D:
    return dwt2d_ns(x, quads, levels, mesh, swt=True, **kw)


def iswt2d_ns(coeffs, quads_inv, mesh, *, shape=None, **kw):
    return idwt2d_ns(coeffs, quads_inv,
                     tuple(coeffs.approx.shape[-2:]) if shape is None else shape, mesh,
                     swt=True, **kw)
