"""Size bookkeeping for decimated transforms (counterpart of
``pdwt_tpu/core/shapes.py``).  Odd sizes round up when subsampling, and
the decomposition depth is clamped to ``ilog2(N / (hlen - 1))``."""
from __future__ import annotations

from typing import List, Tuple


def div2(n: int) -> int:
    """Subsampled size; odd sizes round up."""
    return (n + 1) // 2


def ilog2(n: int) -> int:
    """floor(log2(n)) for n >= 1, 0 otherwise."""
    return n.bit_length() - 1 if n >= 1 else 0


def max_level(min_dim: int, hlen: int) -> int:
    """Maximum decomposition depth."""
    return ilog2(min_dim // (hlen - 1)) if hlen > 1 else ilog2(min_dim)


def level_sizes(n: int, levels: int) -> List[int]:
    """[n, div2(n), div2(div2(n)), ...], of length levels + 1."""
    sizes = [n]
    for _ in range(levels):
        sizes.append(div2(sizes[-1]))
    return sizes


def coeff_shapes_2d(nr: int, nc: int, levels: int, do_swt: bool = False
                    ) -> Tuple[Tuple[int, int], List[Tuple[int, int]]]:
    """(approx_shape, [detail_shape per level 1..levels]).  The DWT halves
    per level with round-up; the SWT keeps the full size."""
    if do_swt:
        return (nr, nc), [(nr, nc)] * levels
    rows = level_sizes(nr, levels)
    cols = level_sizes(nc, levels)
    details = [(rows[i + 1], cols[i + 1]) for i in range(levels)]
    return details[-1], details
