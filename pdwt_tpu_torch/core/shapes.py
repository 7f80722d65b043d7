"""Size bookkeeping for decimated transforms (counterpart of
``pdwt_tpu/core/shapes.py``).  Under periodization odd sizes round up when
subsampling; the pywt modes follow their own rule (``core/modes.py``).
The decomposition depth is clamped to ``ilog2(N / (hlen - 1))``."""
from __future__ import annotations

from typing import List, Tuple

from . import modes


def div2(n: int) -> int:
    """Subsampled size; odd sizes round up."""
    return (n + 1) // 2


def ilog2(n: int) -> int:
    """floor(log2(n)) for n >= 1, 0 otherwise."""
    return n.bit_length() - 1 if n >= 1 else 0


def max_level(min_dim: int, hlen: int) -> int:
    """Maximum decomposition depth."""
    return ilog2(min_dim // (hlen - 1)) if hlen > 1 else ilog2(min_dim)


def level_sizes(n: int, levels: int, hlen: int = 0, mode: str = "periodization") -> List[int]:
    """[n, div2(n), div2(div2(n)), ...], of length levels + 1; under a
    pywt ``mode`` the sizes of ``modes.level_sizes`` (they depend on
    ``hlen``)."""
    if mode != "periodization":
        return modes.level_sizes(n, levels, hlen, mode)
    sizes = [n]
    for _ in range(levels):
        sizes.append(div2(sizes[-1]))
    return sizes


def coeff_shapes_2d(nr: int, nc: int, levels: int, do_swt: bool = False,
                    mode="periodization", hlen: int = 0
                    ) -> Tuple[Tuple[int, int], List[Tuple[int, int]]]:
    """(approx_shape, [detail_shape per level 1..levels]).  The DWT halves
    per level with round-up under periodization, and follows each axis's
    pywt rule under a ``mode`` (a string or a (row, column) tuple; the
    sizes depend on ``hlen``); the SWT keeps the full size."""
    if do_swt:
        return (nr, nc), [(nr, nc)] * levels
    mode_r, mode_c = modes.per_axis(mode, 2)
    rows = level_sizes(nr, levels, hlen, mode_r)
    cols = level_sizes(nc, levels, hlen, mode_c)
    details = [(rows[i + 1], cols[i + 1]) for i in range(levels)]
    return details[-1], details


def coeff_shapes_1d(n: int, levels: int, do_swt: bool = False, mode="periodization",
                    hlen: int = 0) -> Tuple[int, List[int]]:
    """(approx_length, [detail_length per level 1..levels]) of a length-n
    signal, by the same rules."""
    if do_swt:
        return n, [n] * levels
    (mode,) = modes.per_axis(mode, 1)
    sizes = level_sizes(n, levels, hlen, mode)
    return sizes[-1], sizes[1:]


def coeff_shapes_3d(nd: int, nr: int, nc: int, levels: int, do_swt: bool = False,
                    mode="periodization", hlen: int = 0
                    ) -> Tuple[Tuple[int, int, int], List[Tuple[int, int, int]]]:
    """(approx_shape, [detail_shape per level 1..levels]) of an nd x nr x nc
    volume, by the rules of :func:`coeff_shapes_2d` per axis (``mode``: a
    string or a (depth, row, column) tuple)."""
    if do_swt:
        return (nd, nr, nc), [(nd, nr, nc)] * levels
    chains = [level_sizes(n, levels, hlen, m)
              for n, m in zip((nd, nr, nc), modes.per_axis(mode, 3))]
    details = [tuple(ch[i + 1] for ch in chains) for i in range(levels)]
    return details[-1], details
