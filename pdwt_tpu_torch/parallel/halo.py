"""Ring halo exchange, the distributed form of periodic padding:
counterpart of ``pdwt_tpu/parallel/halo.py`` on ``torch.distributed``.

When an axis is sharded over the ranks of one mesh axis, the samples a
filter window needs past the local shard live on its ring neighbours, and
the periodic wrap is the wrap of the ring: the low pad of shard 0 comes
from the tail of shard n - 1.  :func:`ring_wrap_pad` fetches them with
``torch.distributed.batch_isend_irecv``, one send and one receive per hop
and side; a halo wider than the shard (a deep a-trous level, whose span is
``(hlen - 1) 2^(level-1)``) takes several hops.  It is the ``pad_fn`` of the
conv passes (``core/conv.py``) and of the padded kernel entry points.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..core.conv import _sl, wrap_pad


def _exchange(sends: List[torch.Tensor], peers_out: List[int], recv_like: List[torch.Tensor],
              peers_in: List[int], group) -> List[torch.Tensor]:
    """Send ``sends[k]`` to global rank ``peers_out[k]`` and receive a
    tensor shaped as ``recv_like[k]`` from ``peers_in[k]``, all in one
    batch, posted in the same order on every rank of ``group``."""
    dev = recv_like[0].device if recv_like else torch.device("cpu")
    # gloo's send and receive take host tensors only: a gloo group stages
    # the halo slices of card tensors through host memory (the card's own
    # transport, NCCL, sends them from device memory)
    host = dev.type != "cpu" and dist.get_backend(group) == "gloo"
    outs = [(t.cpu() if host else t).contiguous() for t in sends]
    ins = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if host else t.device)
           for t in recv_like]
    ops = []
    for k, (o, i) in enumerate(zip(outs, ins)):
        ops.append(dist.P2POp(dist.isend, o, peers_out[k], group, tag=k))
        ops.append(dist.P2POp(dist.irecv, i, peers_in[k], group, tag=k))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [t.to(dev) for t in ins] if host else ins


def ring_wrap_pad(x: torch.Tensor, axis: int, lo: int, hi: int, *, mesh,
                  axis_name: str) -> torch.Tensor:
    """Periodic pad of a sharded axis by ring exchange: ``x`` is the local
    shard along mesh axis ``axis_name``; the result has ``lo`` (``hi``)
    more samples below (above), the tail of the shards to the left (the
    head of those to the right), ``(i - k) mod n`` (``(i + k) mod n``) for
    hop k.  A one-shard axis takes :func:`wrap_pad`.  Every rank of the
    axis calls it with the same widths."""
    names = tuple(mesh.mesh_dim_names)
    dim = names.index(axis_name)
    n_shards = mesh.shape[dim]
    if n_shards == 1:
        return wrap_pad(x, axis, lo, hi)
    ax = axis % x.ndim
    n = x.shape[ax]
    group = mesh.get_group(axis_name)
    me = mesh.get_local_rank(axis_name)
    peer = lambda k: dist.get_global_rank(group, (me + k) % n_shards)
    sends, outs, like, ins, side = [], [], [], [], []
    for sign, width in ((-1, lo), (1, hi)):
        rem, k = width, 1
        while rem > 0:
            take = min(rem, n)
            # the low pad takes each left shard's tail, the high pad each
            # right shard's head
            sl = _sl(x, ax, n - take, n) if sign < 0 else _sl(x, ax, 0, take)
            side.append((sign, k, sl))
            rem -= take
            k += 1
    local = {}
    for j, (sign, k, sl) in enumerate(side):
        if k % n_shards == 0:  # the hop comes back to this shard
            local[j] = sl
            continue
        sends.append(sl)
        outs.append(peer(-sign * k))
        like.append(sl)
        ins.append(peer(sign * k))
    got = iter(_exchange(sends, outs, like, ins, group))
    parts = [local[j] if j in local else next(got) for j in range(len(side))]
    left = [p for (sign, _, _), p in zip(side, parts) if sign < 0][::-1]
    right = [p for (sign, _, _), p in zip(side, parts) if sign > 0]
    if not left and not right:
        return x
    return torch.cat(left + [x] + right, dim=ax)


def make_pad_fn(mesh, row_axis: Optional[str] = None, col_axis: Optional[str] = None,
                dep_axis: Optional[str] = None):
    """A ``pad_fn(x, axis, lo, hi)`` dispatching per trailing axis: the ring
    exchange over ``dep_axis`` on axis -3 (the depth of a (B, D, R, C)
    volume), over ``row_axis`` on axis -2 and over ``col_axis`` on axis -1,
    :func:`wrap_pad` on an axis that no mesh axis shards."""
    rings = {3: dep_axis, 2: row_axis, 1: col_axis}

    def pad_fn(x, axis, lo, hi):
        name = rings.get(x.ndim - axis % x.ndim)
        if name is not None:
            return ring_wrap_pad(x, axis, lo, hi, mesh=mesh, axis_name=name)
        return wrap_pad(x, axis, lo, hi)

    return pad_fn
