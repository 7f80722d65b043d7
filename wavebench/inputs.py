"""The one generator of the benchmark's inputs: a cell's ``input`` entry
(data) made into a float32 tensor on the device, from the run's seed.

Kinds:

* ``uniform``: i.i.d. uniform samples in ``[low, high)``;
* ``phantom``: per batch item, a background level and ``ellipsoids``
  axis-aligned ellipsoids painted in order, each of a level drawn in
  ``[low, high)``, its center uniform in the unit cube and its semi-axes in
  ``[0.05, 0.4)`` of each side; then Gaussian noise of ``noise_sigma``.

Every draw comes from one ``torch.Generator`` on the device, in a fixed
order, so a seed gives the same inputs, and every seed the same shapes.
"""
from __future__ import annotations

from typing import Sequence

import torch

SEMI_AXES = (0.05, 0.4)


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with any whole number (taken mod
    2^64, which ``manual_seed`` holds)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)


def _uniform(shape, low: float, high: float, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32) * (high - low) + low


def make(spec: dict, shape: Sequence[int], ndim: int, gen: torch.Generator,
         device: torch.device) -> torch.Tensor:
    """The input of ``shape``: leading axes the batch, the trailing ``ndim``
    the transformed ones."""
    shape = tuple(int(n) for n in shape)
    kind = spec["kind"]
    low, high = float(spec["low"]), float(spec["high"])
    if kind == "uniform":
        return _uniform(shape, low, high, gen, device)
    if kind != "phantom":
        raise ValueError(f"unknown input kind {kind!r}")
    batch, spatial = shape[:-ndim], shape[-ndim:]
    nb, ne = int(torch.Size(batch).numel()), int(spec["ellipsoids"])
    background = _uniform((nb,), low, high, gen, device)
    levels = _uniform((nb, ne), low, high, gen, device)
    centers = _uniform((nb, ne, ndim), 0.0, 1.0, gen, device)
    axes = _uniform((nb, ne, ndim), *SEMI_AXES, gen, device)
    out = background.reshape((nb,) + (1,) * ndim).expand((nb,) + spatial).clone()
    grids = [(torch.arange(n, device=device, dtype=torch.float32) + 0.5) / n for n in spatial]
    for e in range(ne):
        q = torch.zeros((nb,) + spatial, device=device, dtype=torch.float32)
        for d, g in enumerate(grids):
            c = centers[:, e, d].reshape([nb] + [1] * ndim)
            a = axes[:, e, d].reshape([nb] + [1] * ndim)
            q += ((g.reshape([1] * (1 + d) + [spatial[d]] + [1] * (ndim - 1 - d)) - c) / a) ** 2
        out = torch.where(q <= 1.0, levels[:, e].reshape([nb] + [1] * ndim), out)
    noise = torch.randn((nb,) + spatial, generator=gen, device=device, dtype=torch.float32)
    out = out + float(spec["noise_sigma"]) * noise
    return out.reshape(shape).contiguous()
