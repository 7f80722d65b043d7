"""Circular shift for cycle spinning (counterpart of
``pdwt_tpu/ops/shift.py``)."""
from __future__ import annotations

import torch


def circshift2d(x: torch.Tensor, sr: int, sc: int) -> torch.Tensor:
    """out[y, x] = in[(y - sr) mod Nr, (x - sc) mod Nc] over the trailing
    two axes."""
    return torch.roll(x, (int(sr), int(sc)), dims=(-2, -1))
