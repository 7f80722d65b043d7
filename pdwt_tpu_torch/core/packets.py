"""Wavelet packet transforms with the Coifman-Wickerhauser best-basis search
(counterpart of ``pdwt_tpu/core/packets.py``).

The packet tree is not a tree of kernel calls: at depth ``j`` all ``4^j``
(2D), ``2^j`` (1D) or ``8^j`` (3D) nodes are stacked on one axis, and that
axis rides the batch of ONE single-level transform (``dwt2d``, ``dwt1d``,
``dwt3d``), so a full decomposition costs one level launch per depth (kernel
1 or the one-level tail 3 in 2D, 7 in 1D, 11 and 15 where a tier's route
accepts the depth's node size) and inherits every precision tier.

Node ordering is natural (Paley): child ``k`` of node ``i`` at depth ``j``
is node ``fan*i + k`` at depth ``j+1``, with ``k`` in (a, h, v, d) =
(0, 1, 2, 3) in 2D, (a, d) in 1D and (aaa,) + ``DETAIL_KEYS_3D`` in 3D.

Best basis (Coifman and Wickerhauser 1992): an additive cost per node,
reduced in float32 on the nodes' device, copied to the host once for all
depths, then bottom-up dynamic programming in float64 on the host, each
node kept as a leaf or replaced by the union of its children's best bases.
The float32 sums run in another order than JAX's, so at a near-tie (a
parent's cost within float32 roundoff of its children's sum) the two can
pick different bases; both are bases of the same tree.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..filters import Wavelet
from .separable import Coeffs1D, Coeffs2D, dwt1d, dwt2d, idwt1d, idwt2d
from .separable3d import Coeffs3D, dwt3d, idwt3d
from .shapes import level_sizes


class Packets1D(NamedTuple):
    """Full packet tree of a 1D signal: ``nodes[j]`` has shape
    ``batch + (2**j, n_j)``; depth 0 is the signal itself."""
    nodes: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.nodes) - 1


class Packets2D(NamedTuple):
    """Full packet tree of an image: ``nodes[j]`` has shape
    ``batch + (4**j, r_j, c_j)``; depth 0 is the image itself."""
    nodes: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.nodes) - 1


class Packets3D(NamedTuple):
    """Full packet tree of a volume: ``nodes[j]`` has shape
    ``batch + (8**j, d_j, r_j, c_j)``; depth 0 is the volume itself.
    Child ordering within a split: (aaa,) + DETAIL_KEYS_3D."""
    nodes: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.nodes) - 1


def _geom(packets):
    """(spatial ndim, fan-out, node axis) of a packet tree."""
    if isinstance(packets, Packets3D):
        return 3, 8, -4
    if isinstance(packets, Packets2D):
        return 2, 4, -3
    if isinstance(packets, Packets1D):
        return 1, 2, -2
    raise TypeError(f"expected a Packets tree, got {type(packets)}")


def _split(a: torch.Tensor, dets, sd: int) -> torch.Tensor:
    """One depth's children stacked on the node axis: (..., n, fan, *sp)
    -> (..., fan*n, *sp).  Under the bf16 tiers the approximation comes out
    float32 beside bf16 details; it is cast to theirs, as JAX casts."""
    if a.dtype != dets[0].dtype:
        a = a.to(dets[0].dtype)
    stk = torch.stack((a,) + tuple(dets), dim=-sd - 1)
    return stk.reshape(tuple(a.shape[:-sd - 1]) + (-1,) + tuple(a.shape[-sd:]))


def wp2d(x: torch.Tensor, wav: Wavelet, levels: int, *,
         backend: Optional[str] = None) -> Packets2D:
    """Full 2D wavelet packet decomposition over the trailing two axes
    (leading axes are batch); one single-level ``dwt2d`` per depth."""
    nodes = [x.unsqueeze(-3)]
    for _ in range(levels):
        c = dwt2d(nodes[-1], wav, 1, backend=backend)
        nodes.append(_split(c.approx, c.details[0], 2))
    return Packets2D(tuple(nodes))


def wp1d(x: torch.Tensor, wav: Wavelet, levels: int, *,
         backend: Optional[str] = None) -> Packets1D:
    """Full 1D wavelet packet decomposition over the trailing axis."""
    nodes = [x.unsqueeze(-2)]
    for _ in range(levels):
        c = dwt1d(nodes[-1], wav, 1, backend=backend)
        nodes.append(_split(c.approx, (c.details[0],), 1))
    return Packets1D(tuple(nodes))


def wp3d(x: torch.Tensor, wav: Wavelet, levels: int, *,
         backend: Optional[str] = None) -> Packets3D:
    """Full 3D wavelet packet decomposition over the trailing three axes:
    one single-level ``dwt3d`` per depth (node axis = batch, 8 children
    per node)."""
    nodes = [x.unsqueeze(-4)]
    for _ in range(levels):
        c = dwt3d(nodes[-1], wav, 1, backend=backend)
        nodes.append(_split(c.approx, c.details[0], 3))
    return Packets3D(tuple(nodes))


def _depth_of(n: int, fan: int) -> int:
    levels = int(round(math.log(n, fan)))
    if fan ** levels != n:
        raise ValueError(f"node axis {n} is not a power of {fan}")
    return levels


def _band(g: torch.Tensor, k: int, sd: int) -> torch.Tensor:
    return g[(Ellipsis, k) + (slice(None),) * sd]


def _coeffs(g: torch.Tensor, sd: int):
    """The single-level coefficients of grouped children (..., n, fan, *sp)."""
    if sd == 3:
        return Coeffs3D(_band(g, 0, 3), (tuple(_band(g, k, 3) for k in range(1, 8)),))
    if sd == 2:
        return Coeffs2D(_band(g, 0, 2), ((_band(g, 1, 2), _band(g, 2, 2), _band(g, 3, 2)),))
    return Coeffs1D(_band(g, 0, 1), (_band(g, 1, 1),))


def _inv1(wav: Wavelet, sd: int, backend: Optional[str] = None):
    """The single-level inverse of ``sd`` spatial axes: (coeffs, out_shape)."""
    if sd == 3:
        return lambda cfs, out: idwt3d(cfs, wav, out, backend=backend)
    if sd == 2:
        return lambda cfs, out: idwt2d(cfs, wav, out, backend=backend)
    return lambda cfs, out: idwt1d(cfs, wav, out[0], backend=backend)


def _group(kids: torch.Tensor, fan: int, sd: int) -> torch.Tensor:
    n = kids.shape[-sd - 1]
    return kids.reshape(tuple(kids.shape[:-sd - 1]) + (n // fan, fan) + tuple(kids.shape[-sd:]))


def _iwp(leaf_nodes: torch.Tensor, wav: Wavelet, shape, sd: int, fan: int,
         backend: Optional[str]) -> torch.Tensor:
    x = leaf_nodes
    levels = _depth_of(x.shape[-sd - 1], fan)
    sizes = [level_sizes(n, levels) for n in shape]
    inv1 = _inv1(wav, sd, backend)
    for j in range(levels - 1, -1, -1):
        x = inv1(_coeffs(_group(x, fan, sd), sd), tuple(s[j] for s in sizes))
    return x[(Ellipsis, 0) + (slice(None),) * sd]


def iwp2d(leaf_nodes: torch.Tensor, wav: Wavelet, shape: Tuple[int, int], *,
          backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of the FULL packet decomposition from the deepest node
    tensor (``packets.nodes[-1]``); ``shape`` is the original (rows, cols).
    For a pruned (best-basis) tree use :func:`wp_reconstruct`."""
    return _iwp(leaf_nodes, wav, tuple(shape), 2, 4, backend)


def iwp1d(leaf_nodes: torch.Tensor, wav: Wavelet, length: int, *,
          backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of the full 1D packet decomposition from
    ``packets.nodes[-1]``."""
    return _iwp(leaf_nodes, wav, (length,), 1, 2, backend)


def iwp3d(leaf_nodes: torch.Tensor, wav: Wavelet, shape: Tuple[int, int, int], *,
          backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of the full 3D packet decomposition from
    ``packets.nodes[-1]``."""
    return _iwp(leaf_nodes, wav, tuple(shape), 3, 8, backend)


# ---------------------------------------------------------------------------
# best basis
# ---------------------------------------------------------------------------

_EPS = 1e-30
COSTS = ("shannon", "logenergy", "l1", "threshold")


def _node_costs(nodes: torch.Tensor, node_axis: int, cost: str, thresh) -> torch.Tensor:
    """Additive cost per node, in float32: reduce every axis but ``node_axis``."""
    x = nodes.to(torch.float32)
    axes = tuple(i for i in range(x.ndim) if i != node_axis % x.ndim)
    if cost == "shannon":
        e = x * x
        return -torch.sum(e * torch.log(e + _EPS), dim=axes)
    if cost == "logenergy":
        return torch.sum(torch.log(x * x + _EPS), dim=axes)
    if cost == "l1":
        return torch.sum(x.abs(), dim=axes)
    t = torch.full((), thresh, dtype=torch.float32, device=x.device)
    return torch.sum((x.abs() > t).to(torch.float32), dim=axes)


def wp_costs(packets, cost: str = "shannon", thresh: float = 0.0):
    """Per-depth per-node additive costs (float32 tensors on the nodes'
    device): ``"shannon"`` (-sum x^2 ln x^2), ``"logenergy"`` (sum ln x^2),
    ``"l1"`` or ``"threshold"`` (the count above ``thresh``), aggregated
    over any batch axes."""
    _, _, axis = _geom(packets)
    if cost not in COSTS:
        raise ValueError(f"unknown cost {cost!r}")
    return [_node_costs(nd, axis, cost, thresh) for nd in packets.nodes]


def best_basis(packets, cost: str = "shannon",
               thresh: float = 0.0) -> Tuple[Tuple[Tuple[int, int], ...], float]:
    """Coifman-Wickerhauser best-basis search.  Returns ``(leaves,
    total_cost)`` with ``leaves`` a tuple of ``(depth, node_index)`` forming
    a disjoint cover of the root, to pass to :func:`wp_reconstruct`.  The
    costs (:func:`wp_costs`) come to the host in one copy; a node splits
    when its children's best sum is strictly below its own cost (float64),
    one shared basis for the whole batch.  Sharded nodes (DTensors, from
    ``parallel.packets``) reduce to partial sums that ``full_tensor()``
    all-reduces, a collective a depth and sharded mesh axis."""
    _, fan, _ = _geom(packets)
    per_depth = [c.full_tensor() if hasattr(c, "full_tensor") else c
                 for c in wp_costs(packets, cost, thresh)]
    flat = torch.cat(per_depth).cpu().numpy().astype(np.float64)
    costs = np.split(flat, np.cumsum([c.numel() for c in per_depth])[:-1])
    levels = packets.levels
    best = [None] * (levels + 1)
    split = [None] * (levels + 1)
    best[levels] = costs[levels]
    split[levels] = np.zeros_like(costs[levels], dtype=bool)
    for j in range(levels - 1, -1, -1):
        child_sum = best[j + 1].reshape(-1, fan).sum(axis=1)
        split[j] = child_sum < costs[j]
        best[j] = np.where(split[j], child_sum, costs[j])
    leaves = []

    def walk(j, i):
        if split[j][i]:
            for k in range(fan):
                walk(j + 1, fan * i + k)
        else:
            leaves.append((j, int(i)))

    walk(0, 0)
    return tuple(leaves), float(best[0][0])


def wp_reconstruct(packets, leaves: Sequence[Tuple[int, int]], wav: Wavelet, *,
                   backend: Optional[str] = None, map_fn=None, inv1_fn=None) -> torch.Tensor:
    """Reconstruct the signal, image or volume from a pruned packet tree:
    the coefficients of the ``leaves`` cover (as from :func:`best_basis`),
    each optionally transformed by ``map_fn(node, depth, index)`` (a
    threshold, say) before synthesis.  Per depth, every completed sibling
    group (pair, quad or octet) is synthesized by one batched single-level
    inverse.

    ``inv1_fn(coeffs, out_shape)`` overrides that single-level inverse;
    ``coeffs`` is the matching ``Coeffs1D``/``2D``/``3D``; ``backend`` is
    the default inverse's route (``core/separable.py``)."""
    sd, fan, axis = _geom(packets)
    levels = packets.levels
    sizes = [level_sizes(n, levels) for n in packets.nodes[0].shape[-sd:]]
    inv1 = inv1_fn if inv1_fn is not None else _inv1(wav, sd, backend)

    def sl(nd, i):
        return nd[(Ellipsis, i) + (slice(None),) * sd]

    cover = sorted(set((int(j), int(i)) for j, i in leaves))
    cur = {}
    for j, i in cover:
        if not 0 <= j <= levels:
            raise ValueError(f"leaf depth {j} outside tree of {levels}")
        val = sl(packets.nodes[j], i)
        cur.setdefault(j, {})[i] = val if map_fn is None else map_fn(val, j, i)
    for j in range(levels, 0, -1):
        layer = cur.pop(j, {})
        if not layer:
            continue
        idx = sorted(layer)
        parents = sorted(set(i // fan for i in idx))
        want = [fan * p + k for p in parents for k in range(fan)]
        if idx != want:
            raise ValueError(f"leaves do not tile depth {j}: {idx}")
        kids = torch.stack([layer[i] for i in idx], dim=axis)
        vals = inv1(_coeffs(_group(kids, fan, sd), sd), tuple(s[j - 1] for s in sizes))
        up = cur.setdefault(j - 1, {})
        for t, p in enumerate(parents):
            if p in up:
                raise ValueError(f"overlapping cover at depth {j-1}/{p}")
            up[p] = sl(vals, t)
    top = cur.get(0, {})
    if sorted(top) != [0]:
        raise ValueError("leaves do not cover the root")
    return top[0]


def threshold_details(packets, leaves: Sequence[Tuple[int, int]], thr, beta):
    """The tree with ``thr(node, beta)`` applied to every node of the
    depths ``leaves`` reaches, but node 0 of each (the pure approximation
    chain).  ``wp_reconstruct`` on it with ``leaves`` gives the bits of
    ``wp_reconstruct(packets, leaves, wav, map_fn=lambda v, j, i: v if i ==
    0 else thr(v, beta))``: the threshold is elementwise, so one pass over a
    depth's node tensor stands for one pass a leaf (a 5-level best basis of
    an image has up to 1024 leaves)."""
    sd, _, _ = _geom(packets)
    depths = {int(j) for j, _ in leaves}
    nodes = list(packets.nodes)
    for j in depths - {0}:
        out = thr(nodes[j], beta)
        zero = (Ellipsis, 0) + (slice(None),) * sd
        out[zero] = nodes[j][zero]
        nodes[j] = out
    return type(packets)(tuple(nodes))
