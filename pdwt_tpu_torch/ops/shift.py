"""Circular shifts for cycle spinning (counterpart of
``pdwt_tpu/ops/shift.py``).  Shifts are drawn from a ``torch.Generator``
where JAX takes a PRNG key."""
from __future__ import annotations

from typing import Tuple

import torch


def circshift2d(x: torch.Tensor, sr: int, sc: int) -> torch.Tensor:
    """out[y, x] = in[(y - sr) mod Nr, (x - sc) mod Nc] over the trailing
    two axes."""
    return torch.roll(x, (int(sr), int(sc)), dims=(-2, -1))


def circshift3d(x: torch.Tensor, sd: int, sr: int, sc: int) -> torch.Tensor:
    """out[z, y, x] = in[(z - sd) mod Nd, (y - sr) mod Nr, (x - sc) mod Nc]
    over the trailing three axes."""
    return torch.roll(x, (int(sd), int(sr), int(sc)), dims=(-3, -2, -1))


def circshift1d(x: torch.Tensor, sc: int) -> torch.Tensor:
    """Circular shift along the last axis (1D data has no row shift)."""
    return torch.roll(x, int(sc), dims=-1)


def random_shift(generator: torch.Generator, shape: Tuple[int, int]) -> Tuple[int, int]:
    """(sr, sc) uniform in [0, Nr) x [0, Nc): the row shift, then the
    column shift, drawn from ``generator`` on its device."""
    draw = lambda n: int(torch.randint(0, n, (), generator=generator, device=generator.device))
    return draw(shape[0]), draw(shape[1])
