"""The comparison that decides ``correct``: the program's outputs against
the plain reference, as the largest gap relative to the reference's
largest magnitude, accumulated block by block."""
from __future__ import annotations

import math
from typing import List

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of an output tree in order (a coefficient tree is its
    approximation, then each level's bands)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for item in tree for t in leaves(item)]


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


class MaxRel:
    """max |got - ref| / max |ref| over every block added; ``inf`` once a
    block does not match in shape or holds a non-finite gap."""

    def __init__(self):
        self.gap = 0.0
        self.scale = 0.0

    def add(self, got: List[torch.Tensor], ref: List[torch.Tensor]) -> None:
        if len(got) != len(ref) or any(g.shape != r.shape for g, r in zip(got, ref)):
            self.gap = math.inf
            return
        for g, r in zip(got, ref):
            self.gap = max(self.gap, _finite(float((g.double() - r.double()).abs().max())))
            self.scale = max(self.scale, float(r.abs().max()))

    def value(self) -> float:
        if self.gap == math.inf or self.scale == 0.0:
            return math.inf
        return self.gap / self.scale


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref| / |ref| of two scalars."""
    return _finite(abs(float(got) - float(ref)) / abs(float(ref)))
